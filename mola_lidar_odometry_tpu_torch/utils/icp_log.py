"""ICP debug logs — the ``.icplog`` analogue.

The reference's mp2p_icp writes per-align debug files with pairings and
partial solutions per iteration, decimated, for offline inspection with
icp-log-viewer (reference pipelines/lidar3d-default.yaml:172-182:
``saveIterationDetails``, ``decimationIterationDetails``,
``debugFileNameFormat``, ``decimationDebugFiles``; pre-log layer filter
LidarOdometry.cpp:358-365).

Device-side, the ICP loop is one ``lax.while_loop`` — per-iteration state
cannot stream to the host without breaking the program.  Instead, when debug
logging is enabled the host runs a *replay*: after a scan is processed it
re-executes the align with a fixed iteration schedule that records the pose
trajectory and pairing counts per iteration (bounded, fixed shape), then
writes one ``.icplog.npz`` per logged frame.  Decimation keeps this off the
hot path (every Nth frame only), exactly like the reference's
``decimationDebugFiles``.

Port of ``mola_lidar_odometry_tpu/utils/icp_log.py``.  The replay is a plain
loop over preallocated ``(B, n_iters, ...)`` tensors with the fleet
dimension B (one instance on the host API): every iteration re-captures at
its pose and pairs through the generic matcher, so on lidar3d-default each
iteration launches kernel B4 (``pallas_match.nn_select``) once per matcher.
The loop reads nothing back: its one host copy is the caller's, after it.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional

import numpy as np


class IcpLogWriter:
    """Frame-decimated writer of ICP iteration logs."""

    def __init__(
        self,
        directory: str = "icp-logs",
        decimation: int = 10,
        max_logged_iterations: int = 40,
    ):
        self.dir = Path(directory)
        self.decimation = max(1, int(decimation))
        self.max_iters = int(max_logged_iterations)
        self._frame = 0
        self._made = False

    def want_frame(self) -> bool:
        take = (self._frame % self.decimation) == 0
        self._frame += 1
        return take

    def log(
        self,
        *,
        frame_idx: int,
        stamp: float,
        poses_R: np.ndarray,  # (I, 3, 3) per-iteration poses
        poses_t: np.ndarray,  # (I, 3)
        paired: np.ndarray,  # (I,) pairing counts
        quality: float,
        iterations: int,
        extra: Optional[Dict[str, np.ndarray]] = None,
    ) -> Path:
        if not self._made:
            self.dir.mkdir(parents=True, exist_ok=True)
            self._made = True
        path = self.dir / f"icp-run-{frame_idx:06d}.icplog.npz"
        np.savez_compressed(
            path,
            stamp=np.float64(stamp),
            poses_R=np.asarray(poses_R, np.float32),
            poses_t=np.asarray(poses_t, np.float32),
            paired=np.asarray(paired, np.int32),
            quality=np.float32(quality),
            iterations=np.int32(iterations),
            **(extra or {}),
        )
        return path


def replay_align_with_trace(
    maps, layers, init_pose, prior, cfg, env, n_iters: int, detail_every: int = 0
):
    """Re-run an align with a FIXED iteration schedule, recording each
    iteration's pose and pairing count: returns ``(Rs (B, I, 3, 3), ts (B,
    I, 3), paired (B, I) i32, details)``.

    With ``detail_every > 0`` (the reference's ``saveIterationDetails`` +
    ``decimationIterationDetails``, pipelines/lidar3d-default.yaml:178-180)
    every ``detail_every``-th iteration ALSO records the first matcher's
    full pairing set: per local point, its sensor-frame coordinates, the
    matched map target, the squared distance, and validity — the partial
    solutions an icp-log viewer inspects; ``details`` is then ``(B,
    ceil(I / detail_every), N, 8)`` f32, else None."""
    import torch

    from mola_lidar_odometry_tpu_torch.ops import icp as icp_ops, se3
    from mola_lidar_odometry_tpu_torch.ops.solver import solve_gauss_newton_blocks

    want_details = detail_every > 0
    xyz0 = layers[cfg.matchers[0].local_layer][0]
    B, n_local, dev = xyz0.shape[0], xyz0.shape[1], xyz0.device
    n_detail = (n_iters + detail_every - 1) // detail_every if want_details else 0
    Rs = torch.zeros((B, n_iters, 3, 3), dtype=torch.float32, device=dev)
    ts = torch.zeros((B, n_iters, 3), dtype=torch.float32, device=dev)
    paired_log = torch.zeros((B, n_iters), dtype=torch.int32, device=dev)
    det = torch.zeros((B, max(n_detail, 1), n_local, 8), dtype=torch.float32, device=dev)
    pose = init_pose
    for it in range(n_iters):
        env_it = dict(env)
        env_it["ICP_ITERATION"] = torch.full((B,), float(it), dtype=torch.float32, device=dev)
        it_b = torch.full((B,), it, dtype=torch.int32, device=dev)
        candsets = icp_ops._capture_all(cfg, maps, layers, pose)
        blocks, paired, _ = icp_ops._matcher_blocks(cfg, candsets, layers, pose, env_it, it_b)
        if want_details and it % detail_every == 0:
            b0 = blocks[0]
            tp_g = se3.transform(pose, b0.p_local)  # map frame, at THIS pose
            det[:, it // detail_every] = torch.cat(
                [
                    b0.p_local,  # sensor-frame local points
                    b0.q_global,  # matched map targets
                    torch.sum((b0.q_global - tp_g) ** 2, dim=-1, keepdim=True),
                    b0.valid.to(torch.float32)[..., None],
                ],
                dim=-1,
            )
        pose, _ = solve_gauss_newton_blocks(pose, blocks, cfg.kernel_param(env_it), prior, cfg.gn_inner_iterations)
        Rs[:, it] = pose.R
        ts[:, it] = pose.t
        paired_log[:, it] = paired.to(torch.int32)
    return Rs, ts, paired_log, (det if want_details else None)
