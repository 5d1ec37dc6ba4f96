"""Host-side visualization: live odometry snapshots without a GUI stack.

Port of ``mola_lidar_odometry_tpu/utils/viz.py``.  The odometry's carry
lives on the card; :func:`host_stats` copies what the panel shows to the
host in one transfer, and the map comes in one more.

Counterpart of the reference's visualization layer (mola_viz nanogui window,
reference module/src/LidarOdometry.cpp:1637-2077: decimated local-map
render, path polyline, raw scan recolored by z, stats overlay).  TPU hosts
are headless, so instead of an interactive window this renders matplotlib
snapshots (top-down map + trajectory + stats panel) to PNG — suitable for
periodic dumps during long runs and for notebook use.  The GUI's *control*
surface (pause/resume, save map) maps to the request queue in
utils/runtime.py (enqueue_request), mirroring how the reference marshals
GUI mutations onto the odometry thread.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Union

import torch


def host_stats(lo) -> dict:
    """The GUI label block's carry values of a one-instance odometry, copied
    to the host in one transfer: ICP quality and iterations, sigma, the
    estimated sensor range, the pose translation, the last twist, the
    mapping flag and each map layer's live voxels."""
    c = lo.carry
    names = list(c.maps)
    flat = torch.cat([
        torch.stack([c.last_icp_quality[0], c.last_icp_iters[0], c.sigma[0], c.est_range[0]]).to(torch.float64),
        c.pose_t[0].to(torch.float64), c.last_twist[0].to(torch.float64),
        c.mapping_enabled[:1].to(torch.float64),
        torch.stack([c.maps[k].num_voxels()[0] for k in names]).to(torch.float64) if names
        else torch.zeros(0, dtype=torch.float64, device=c.sigma.device),
    ]).cpu().numpy()
    return {
        "icp_quality": float(flat[0]), "icp_iterations": int(flat[1]), "sigma": float(flat[2]),
        "est_range": float(flat[3]), "pose_t": flat[4:7].copy(), "twist": flat[7:13].copy(),
        "mapping": bool(flat[13]), "map_voxels": {k: int(v) for k, v in zip(names, flat[14:])},
    }



def render_snapshot(
    lo,
    path: Union[str, Path],
    *,
    max_points: int = 200_000,
    title: Optional[str] = None,
) -> None:
    """Render a top-down snapshot: local map, trajectory, current pose."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    pts = lo.local_map_pointcloud(capacity=max_points)
    traj = lo.estimated_trajectory()

    fig, (ax, ax2) = plt.subplots(
        1, 2, figsize=(12, 6), gridspec_kw={"width_ratios": [3, 1]}
    )
    if len(pts):
        z = pts[:, 2]
        ax.scatter(pts[:, 0], pts[:, 1], c=z, s=0.5, cmap="viridis", alpha=0.6)
    if len(traj["stamps"]):
        ax.plot(traj["t"][:, 0], traj["t"][:, 1], "r-", lw=1.5, label="trajectory")
        ax.plot(traj["t"][-1, 0], traj["t"][-1, 1], "r^", ms=10, label="current")
    ax.set_aspect("equal")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    ax.legend(loc="upper right", fontsize=8)
    ax.set_title(title or "local map (top-down)")

    # stats panel — the GUI label block (quality, sigma, range, Hz)
    st = host_stats(lo)
    lines = [
        f"frames: {lo.frames_processed}",
        f"dropped: {lo.frames_dropped}",
        f"traj poses: {len(lo.trajectory)}",
        f"ICP quality: {st['icp_quality']:.3f}",
        f"sigma: {st['sigma']:.3f} m",
        f"est. range: {st['est_range']:.1f} m",
        "map voxels: " + ", ".join(f"{k}={v}" for k, v in st["map_voxels"].items()),
    ]
    hz = lo.profiler.mean_hz("onLidar")
    if hz:
        lines.append(f"rate: {hz:.2f} Hz")
    ax2.axis("off")
    ax2.text(0.02, 0.98, "\n".join(lines), va="top", family="monospace", fontsize=10)
    fig.tight_layout()
    if hasattr(path, "write"):  # file-like (the live viewer's PNG buffer)
        fig.savefig(path, dpi=110, format="png")
    else:
        fig.savefig(str(path), dpi=110)
    plt.close(fig)
