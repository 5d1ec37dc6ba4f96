"""Batched fleet evaluation: B independent odometry instances in one run.

Port of ``eval/fleet_eval.py``.  The reference parallelizes dataset
sequences with ``parallel -j N`` across CPU processes (reference
eval/cli_kitti.sh:23); here B instances run as one fleet, the leading
dimension of the carry, stepped frame by frame (a plain loop where the JAX
script uses ``lax.scan``), on one device or, with ``--devices N``, split
over N devices by ``parallel/batch.py::ShardedFleet`` (one worker process
per device).

Each instance gets its own simulated world and trajectory (world seed b,
trajectory seed 100 + b, as the JAX script).  The report is one JSON line
with the JAX script's keys: per-instance gauge-aligned ATE-RMSE against
the simulator's ground truth, the mean quality and the fleet's throughput.
``compile_s`` is the first run's seconds (the kernels' build and first
launches included; the port compiles no step), ``run_s`` the seconds of one
timed run of the F frames after it, and ``scans_per_sec_per_chip`` B*F over
``run_s`` per device used.  It adds ``device`` and ``devices``.

Usage:
    python -m mola_lidar_odometry_tpu_torch.apps.fleet_eval --batch 8 --frames 25 [--rings 32]
    python -m mola_lidar_odometry_tpu_torch.apps.fleet_eval --batch 2 --frames 3 --rings 16 --device cpu
    python -m mola_lidar_odometry_tpu_torch.apps.fleet_eval --batch 8 --devices 2     # on two cards
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..")


def auto_batch(n_scan_points: int, lo: int = 8, hi: int = 64) -> int:
    """The JAX script's inverse-batch policy: keep the points per step near
    the headline working set (B=8 x 131k points), a power of two clamped to
    [lo, hi]."""
    ref_points = 8 * (1 << 17)
    b = max(1, ref_points // max(n_scan_points, 1))
    b = 1 << (b.bit_length() - 1)
    return max(lo, min(hi, b))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="fleet_eval", description="batched fleet evaluation (PyTorch/CUDA engine)")
    ap.add_argument("--batch", type=int, default=0,
                    help="fleet width; 0 = auto (inverse with scan size, see auto_batch)")
    ap.add_argument("--frames", type=int, default=25)
    ap.add_argument("--rings", type=int, default=32)
    ap.add_argument("--azimuth", type=int, default=1024)
    ap.add_argument("--pipeline", default=os.path.join(ROOT, "pipelines", "lidar3d-default.yaml"))
    ap.add_argument("--raw-capacity", type=int, default=0, help="0 = next power of two >= rings*azimuth")
    ap.add_argument("--map-slots", type=int, default=0,
                    help="0 = auto (derive ALL capacities + budgets from the first scan via "
                         "utils/capacity.py); >0 = manual sizing with this map table size")
    ap.add_argument("--device", default="cuda", help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--devices", type=int, default=0,
                    help="split the fleet over this many devices, one worker process each "
                         "(parallel/batch.py::ShardedFleet; on four H100s it stepped 32 instances slower "
                         "than one card holding them all, see PERF.md); 0 = all instances in this process")
    return ap


def simulate_fleet(batch: int, frames: int, rings: int, azimuth: int):
    """Each instance's own world and trajectory, as the JAX script makes
    them: ``(trajectories, scan lists)``."""
    from mola_lidar_odometry_tpu_torch.utils import sim

    trajs, stacks = [], []
    for b in range(batch):
        traj, scans = sim.simulate_sequence(frames, world_seed=b, traj_seed=100 + b, n_rings=rings,
                                            n_azimuth=azimuth)
        trajs.append(traj)
        stacks.append(scans)
    return trajs, stacks


def fleet_spec(cfg, args, stacks):
    """The spec at the JAX script's sizes: manual with ``--map-slots``, else
    derived from the first scan (the largest scan of the fleet bounds the
    raw buffer)."""
    from mola_lidar_odometry_tpu_torch.models.spec import spec_from_yaml

    if args.map_slots > 0:
        r = args.raw_capacity
        icp = min(1 << 13, max(1024, r // 4))
        return spec_from_yaml(cfg, raw_capacity=r, map_slots=args.map_slots, layer_capacities={
            "raw": r, "decimated_for_map_raw": min(1 << 15, r), "decimated_for_icp_skewed": icp,
            "decimated_for_icp": icp, "decimated_for_map": min(1 << 15, r)})
    from mola_lidar_odometry_tpu_torch.utils.capacity import derive_capacities

    x0, t0, _, v0 = stacks[0][0]
    max_pts = max(int(s[3].sum()) for st in stacks for s in st)
    raw_cap, map_slots, caps, budgets = derive_capacities(spec_from_yaml(cfg), x0[v0], t0[v0], with_budgets=True,
                                                          known_max_points=max_pts)
    print(f"sizing: auto raw={raw_cap} slots={map_slots} layers={caps} budgets={budgets}", file=sys.stderr)
    return spec_from_yaml(cfg, raw_capacity=raw_cap, map_slots=map_slots, layer_capacities=caps,
                          insert_budgets=budgets)


def run_fleet(spec, trajs, stacks, device: str, devices: int):
    """Step every instance over its frames; returns (seconds, (F, B, 3)
    positions, (F, B) qualities)."""
    import torch

    from mola_lidar_odometry_tpu_torch.parallel import batch as pb

    B, F = len(stacks), len(stacks[0])
    ts, qs = [], []
    if devices > 0:
        with pb.ShardedFleet(spec, B, pb.fleet_devices(devices, device), threads=1 if device == "cpu" else 0) as fl:
            t0 = time.time()
            for k in range(F):
                out = fl.step([stacks[b][k] for b in range(B)], [trajs[b].stamps[k] for b in range(B)])
                ts.append(out.pose_t)
                qs.append(out.quality)
            return time.time() - t0, np.stack(ts), np.stack(qs)
    fstep = pb.make_fleet_step(spec)
    carry = pb.init_fleet_carry(spec, B, device=device)
    if device != "cpu":
        torch.cuda.synchronize()
    t0 = time.time()
    for k in range(F):
        carry, out = fstep(carry, pb.pack_scans(spec, [stacks[b][k] for b in range(B)],
                                                [trajs[b].stamps[k] for b in range(B)], device=device))
        ts.append(out.pose_t)
        qs.append(out.quality)
    ts, qs = torch.stack(ts).cpu().numpy(), torch.stack(qs).cpu().numpy()  # waits for the device
    return time.time() - t0, ts, qs


def ate_per_instance(trajs, ts) -> list:
    """Gauge-aligned ATE-RMSE of each instance (positions relative to its
    frame-0 ground truth)."""
    ates = []
    for b, traj in enumerate(trajs):
        R0, t0 = traj.R[0], traj.t[0]
        errs = [np.linalg.norm(ts[k, b] - R0.T @ (traj.t[k] - t0)) for k in range(ts.shape[0])]
        ates.append(float(np.sqrt(np.mean(np.square(errs)))))
    return ates


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    import torch

    from mola_lidar_odometry_tpu_torch.utils.config import load_yaml_file

    if args.device != "cpu" and not torch.cuda.is_available():
        raise SystemExit("fleet_eval: no CUDA device visible; pass --device cpu to run on the CPU")
    n_scan = args.rings * args.azimuth
    if args.raw_capacity <= 0:
        args.raw_capacity = 1 << max(n_scan - 1, 1).bit_length()
    if args.batch <= 0:
        args.batch = auto_batch(n_scan)
        print(f"auto-batch: {args.batch} instances at {n_scan}-pt scans (raw capacity {args.raw_capacity})",
              file=sys.stderr)
    B, F = args.batch, args.frames
    print(f"simulating {B} independent sequences x {F} frames ...", file=sys.stderr)
    trajs, stacks = simulate_fleet(B, F, args.rings, args.azimuth)
    spec = fleet_spec(load_yaml_file(args.pipeline, env={}), args, stacks)

    first_s, _, _ = run_fleet(spec, trajs, stacks, args.device, args.devices)
    dt, ts, q = run_fleet(spec, trajs, stacks, args.device, args.devices)
    ates = ate_per_instance(trajs, ts)
    n_dev = max(args.devices, 1)
    result = {
        "batch": B,
        "frames": F,
        "scans_per_sec_per_chip": round(B * F / dt / n_dev, 2),
        "compile_s": round(first_s, 1),
        "run_s": round(dt, 3),
        "ate_rmse_per_instance_m": [round(a, 3) for a in ates],
        "ate_rmse_mean_m": round(float(np.mean(ates)), 3),
        "mean_quality": round(float(q[1:].mean()), 3),
        "device": args.device if args.device == "cpu" else torch.cuda.get_device_name(0),
        "devices": n_dev,
    }
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
