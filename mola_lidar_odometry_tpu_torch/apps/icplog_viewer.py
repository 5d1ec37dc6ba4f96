"""icp-log-viewer — inspect .icplog.npz debug files.

Port of ``mola_lidar_odometry_tpu/apps/icplog_viewer.py``: a copy: it reads
only the log files.

Counterpart of the external ``icp-log-viewer`` GUI the reference points at
for its ``.icplog`` files (reference docs/mola_lo_pipelines.rst "ICP log
files"; pipelines/lidar3d-default.yaml:177-182).  Renders the per-iteration
pose trajectory and pairing counts of one or more logged align() runs to a
PNG (headless hosts) or prints a text summary.

Usage:
    python -m mola_lidar_odometry_tpu_torch.apps.icplog_viewer icp-logs/*.npz [-o out.png]
"""

from __future__ import annotations

import argparse

import numpy as np


def summarize(path: str) -> dict:
    d = np.load(path)
    t = d["poses_t"]
    steps = np.linalg.norm(np.diff(t, axis=0), axis=1)
    return {
        "file": path,
        "iterations": int(d["iterations"]),
        "quality": float(d["quality"]),
        "final_t": t[-1].tolist(),
        "total_correction_m": float(np.linalg.norm(t[-1] - t[0])),
        "last_step_m": float(steps[-1]) if len(steps) else 0.0,
        "paired_first": int(d["paired"][0]),
        "paired_last": int(d["paired"][-1]),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="icp-log-viewer")
    ap.add_argument("logs", nargs="+", help=".icplog.npz files")
    ap.add_argument("-o", "--output", default=None, help="render PNG here")
    ap.add_argument(
        "--pairings", type=int, default=None, metavar="ITER",
        help="also render the recorded pairing segments of the detail "
        "iteration closest to ITER (needs logs written with "
        "MP2P_ICP_LOG_ITER_DETAILS > 0)",
    )
    args = ap.parse_args(argv)

    infos = [summarize(p) for p in args.logs]
    for info in infos:
        print(
            f"{info['file']}: iters={info['iterations']} q={info['quality']:.3f} "
            f"corr={info['total_correction_m']:.3f}m "
            f"paired {info['paired_first']}->{info['paired_last']}"
        )

    if args.output:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        ncols = 3 if args.pairings is not None else 2
        fig, axes = plt.subplots(1, ncols, figsize=(5.5 * ncols, 5))
        ax1, ax2 = axes[0], axes[1]
        for p in args.logs:
            d = np.load(p)
            t = d["poses_t"]
            ax1.plot(t[:, 0], t[:, 1], ".-", ms=3, label=p.split("/")[-1])
            ax2.plot(d["paired"], label=p.split("/")[-1])
        if args.pairings is not None:
            ax3 = axes[2]
            d = np.load(args.logs[0])
            if "pair_details" not in d:
                ax3.set_title("no pairing details in log")
            else:
                its = d["detail_iters"]
                slot = int(np.argmin(np.abs(its - args.pairings)))
                det = d["pair_details"][slot]
                v = det[:, 7] > 0
                # pairing segments: local point transformed by the pose
                # ENTERING the detail iteration (poses_R/t[i] are recorded
                # AFTER iteration i's update; iteration 0 enters at pose0)
                it0 = int(its[slot])
                if it0 == 0 and "pose0_R" in d:
                    R, tt = d["pose0_R"], d["pose0_t"]
                else:
                    R, tt = d["poses_R"][max(it0 - 1, 0)], d["poses_t"][max(it0 - 1, 0)]
                lp = det[v, :3] @ R.T + tt
                tp = det[v, 3:6]
                for a, b in zip(lp[::5], tp[::5]):  # decimate for legibility
                    ax3.plot([a[0], b[0]], [a[1], b[1]], "-", lw=0.3, c="#888")
                ax3.plot(lp[:, 0], lp[:, 1], ".", ms=1.5, label="local")
                ax3.plot(tp[:, 0], tp[:, 1], ".", ms=1.5, label="map")
                ax3.set_title(f"pairings @ iter {int(its[slot])} ({int(v.sum())})")
                ax3.axis("equal")
                ax3.legend(fontsize=7)
        ax1.set_title("per-iteration pose (x, y)")
        ax1.set_xlabel("x [m]")
        ax1.set_ylabel("y [m]")
        ax1.axis("equal")
        ax2.set_title("pairings per iteration")
        ax2.set_xlabel("iteration")
        if len(args.logs) <= 8:
            ax1.legend(fontsize=7)
        fig.tight_layout()
        fig.savefig(args.output, dpi=110)
        print(f"-> {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
