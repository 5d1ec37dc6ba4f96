"""Cross-pipeline accuracy table on a shared street-scale simulated sequence.

Port of ``eval/cross_pipeline.py``.  Drives every bundled 3D pipeline
configuration through the port's ``LidarOdometry`` over the SAME simulated
sequence and reports the worst gauge-aligned SE(3) log-norm error per
pipeline (the table of ``docs/benchmarks.md``, "Cross-pipeline accuracy").

The sequence is the JAX script's: the bench's world and HDL-64-like sensor
(64 x 2048 rays) at up to 8 m/s with a ``--accel`` launch (3 m/s^2), the
intensities uniform in [0, 100) from ``default_rng(0)``
(``apps/bench_sequence.py``).  Each pipeline runs at the script's ``CAPS``
(131072 raw points and slots, the other layers at the filter graph's
defaults), one vehicle (B = 1).  lidar2d takes 2D scans and is not in the
list, as in the JAX script.  Per frame the quality, the ICP iterations and
the error go to stderr; per pipeline its worst error and its seconds per
frame, then the markdown table, to stdout.  The error is the JAX script's
float32 figure; beside it the same in float64 (``gt_error_f64``).

By default the port runs the JAX package's TPU algorithm (the per-voxel
capture).  ``--per-voxel-nn 0`` runs what the JAX script runs on a CPU by
default: every point of each probed voxel, the generic ICP loop.
``--fused-align 0`` runs the JAX package's ``MOLA_TPU_PALLAS=0`` algorithm:
the per-voxel capture, the generic ICP loop.

Usage:
    python -m mola_lidar_odometry_tpu_torch.apps.cross_pipeline [--frames 12] [--pipelines a.yaml ...]
    python -m mola_lidar_odometry_tpu_torch.apps.cross_pipeline --device cpu --frames 3 --rings 16 --azimuth 512 \\
        --pipelines lidar3d-default.yaml
    python -m mola_lidar_odometry_tpu_torch.apps.cross_pipeline --per-voxel-nn 0   # the JAX script's CPU algorithm
    python -m mola_lidar_odometry_tpu_torch.apps.cross_pipeline --fused-align 0    # MOLA_TPU_PALLAS=0
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", "pipelines")

PIPELINES = [
    "lidar3d-default.yaml",
    "lidar3d-ndt.yaml",
    "rgbd.yaml",
    os.path.join("extras", "lidar3d-kissicp-like.yaml"),
    os.path.join("extras", "lidar3d-dual-map.yaml"),
    os.path.join("extras", "lidar3d-near-far.yaml"),
    os.path.join("extras", "lidar3d-edges.yaml"),
    os.path.join("extras", "lidar3d-intensity.yaml"),
]

CAPS = dict(
    raw_capacity=1 << 17,  # 64x2048 scan = 131072 points exactly
    map_slots=1 << 17,
    layer_capacities={"raw": 1 << 17},  # others take filter_graph defaults
)


def caps_for(raw_capacity: int) -> dict:
    """``CAPS`` for scans of ``raw_capacity`` rays (``CAPS`` itself at the
    bench's 131072; the tests' scans are smaller)."""
    return dict(raw_capacity=raw_capacity, map_slots=max(raw_capacity, 1 << 12),
                layer_capacities={"raw": raw_capacity})


def gt_error(traj, k: int, R, t) -> float:
    """Gauge-aligned SE(3) log-norm of pose ``(R, t)`` against frame ``k``
    of ``traj`` relative to frame 0, in float32 as the JAX script computes
    it."""
    import torch

    from mola_lidar_odometry_tpu_torch.ops import se3

    def pose(R_, t_):
        return se3.Pose(torch.from_numpy(np.array(R_, np.float32)), torch.from_numpy(np.array(t_, np.float32)))

    rel = se3.relative(se3.relative(pose(traj.R[0], traj.t[0]), pose(traj.R[k], traj.t[k])), pose(R, t))
    return float(torch.linalg.norm(se3.se3_log(rel)))


def gt_error_f64(traj, k: int, R, t) -> float:
    """The same error in float64 on the host (``oracle.py``'s ``relative``
    and ``se3_log``).  Both packages' float32 ``se3_log`` leave the small-angle
    series at ``theta^2 < 1e-6``; just above it ``(1 - A / 2B) / theta^2``
    cancels to a few per cent, and a relative rotation of 1-3 mrad moves the
    float32 figure by up to ~0.03 on these sequences, in one package one
    way and in the other another (ROADMAP C16)."""
    from mola_lidar_odometry_tpu_torch.oracle import relative, se3_log

    R0, t0 = traj.R[0], traj.t[0]
    gR, gt = relative(R0, t0, traj.R[k], traj.t[k])
    return float(np.linalg.norm(se3_log(*relative(gR, gt, np.asarray(R, np.float64), np.asarray(t, np.float64)))))


def run_pipeline(path: str, scans, traj, intens, caps: dict, device, log=None, **knobs) -> dict:
    """One pipeline (a YAML path) through ``LidarOdometry`` at ``caps`` over
    ``scans``, fed as the JAX script feeds them; returns its per-frame
    errors, qualities and iterations, the worst error and the seconds per
    frame (each frame's wall time, the readback included).  The errors are
    the JAX script's float32 figure (``errors``, ``worst``) and the same in
    float64 (``errors_f64``, ``worst_f64``).  ``knobs`` are ICP overrides of
    ``spec_from_yaml`` (``models/spec.py::ICP_KNOBS``)."""
    from mola_lidar_odometry_tpu_torch.models.odometry import LidarOdometry

    lo = LidarOdometry.from_yaml_file(path, device=device, **caps, **knobs)
    errs, errs64, quals, iters, secs = [], [], [], [], []
    name = os.path.relpath(path, ROOT) if path.startswith(ROOT) else path
    for k, (xyz, times, rings, valid) in enumerate(scans):
        t0 = time.perf_counter()
        out = lo.on_lidar_scan(xyz[valid], float(traj.stamps[k]), times=times[valid], ring=rings[valid],
                               intensity=intens[k][valid])
        secs.append(time.perf_counter() - t0)
        e = gt_error(traj, k, out.pose_R, out.pose_t)
        errs.append(e)
        errs64.append(gt_error_f64(traj, k, out.pose_R, out.pose_t))
        quals.append(float(out.quality))
        iters.append(int(out.iterations))
        if log is not None:
            print(f"  {name} f{k}: q={quals[-1]:.3f} iters={iters[-1]} err={e:.4f} (float64 {errs64[-1]:.4f})",
                  file=log, flush=True)
    lo.close()
    return dict(name=name, errors=errs, errors_f64=errs64, quality=quals, iterations=iters, worst=max(errs),
                worst_f64=max(errs64), secs=secs)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="cross_pipeline", description="cross-pipeline accuracy table on the "
                                 "shared street-scale sequence (PyTorch/CUDA engine)")
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--pipelines", nargs="*", default=PIPELINES)
    ap.add_argument("--accel", type=float, default=3.0)
    ap.add_argument("--rings", type=int, default=64)
    ap.add_argument("--azimuth", type=int, default=2048)
    ap.add_argument("--device", default="cuda", help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--per-voxel-nn", type=int, choices=(0, 1), default=1,
                    help="0: every point of each probed voxel, the generic ICP loop (the JAX script's CPU default)")
    ap.add_argument("--fused-align", type=int, choices=(0, 1), default=1,
                    help="0: the generic ICP loop over the per-voxel capture (the JAX package's MOLA_TPU_PALLAS=0)")
    return ap


def main(argv=None) -> list:
    args = build_parser().parse_args(argv)
    import torch

    from mola_lidar_odometry_tpu_torch.apps import bench_sequence as bs

    if args.device != "cpu" and not torch.cuda.is_available():
        raise SystemExit("cross_pipeline: no CUDA device visible; pass --device cpu to run on the CPU")
    scans, traj = bs.gen_scans(args.frames, accel=args.accel, n_rings=args.rings, n_azimuth=args.azimuth)
    intens = bs.scan_intensities(scans)
    caps = caps_for(args.rings * args.azimuth)
    rows = []
    for name in args.pipelines:
        r = run_pipeline(os.path.join(ROOT, name), scans, traj, intens, caps, args.device, log=sys.stderr,
                         per_voxel_nn=bool(args.per_voxel_nn), fused_align=bool(args.fused_align))
        rows.append(r)
        print(f"{name}: worst={r['worst']:.3f} (float64 {r['worst_f64']:.3f}; "
              f"{np.mean(r['secs'][1:] or r['secs']):.3f} s/frame after frame 0)", flush=True)
    print("\n| pipeline | worst error |")
    print("|---|---|")
    for r in sorted(rows, key=lambda r: r["worst"]):
        print(f"| {r['name']} | {r['worst']:.3f} |")
    return rows


if __name__ == "__main__":
    main()
