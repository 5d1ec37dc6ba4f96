"""Stage-level timing: where does a scan step spend its time?

Port of ``eval/profile_stages.py``.  Times each stage of the odometry step
alone on the device, with the JAX script's defaults (raw 131072 points, ICP
layer 8192, map layer 65536, 131072 slots, 20 repeats) and its inputs: every
point cloud drawn from ``np.random.default_rng(0)`` uniform in +-60 m, in the
script's order.  The stages: ``decimate_voxels`` (0.35 m into the map
layer), ``filter_by_range``, ``deskew``, the map insert, the whole-table
``prune_farther_than``, ``query_nn`` (27 neighbours), the Gauss-Newton solve
on fixed pairings (2 inner iterations), one align forced to 10 iterations
(the twist hook set so that it never fires: capture once, then iterate; the
JAX script's own setting stops it after one, see :func:`align_config`) and
the whole steady-state step of lidar3d-default at these sizes.

The fleet is an explicit leading dimension B (``--batch``): every instance
gets the same inputs, as the JAX script broadcasts them under ``vmap``.
Each stage is called twice outside the timed window, then ``--repeats``
times between two ``torch.cuda.synchronize()`` (on the CPU, plain wall
time); on a card one more call runs under ``torch.profiler`` and its device
time (kernels, copies and sets summed) is printed beside the wall time, so
that a stage's device share shows.  The map insert and prune update the table in place, so they, and the
step, run on a copy of their input state each call (the JAX program copies
its undonated input too).  Beside each stage the kernels its calls launched
per call, read from the wrappers' launch counters: the align takes the
fused path (B1, B3, B2, B3; ``ops/icp.py::_fused_eligible`` holds for this
configuration), the step launches B1-B3 in its align.  On the CPU the
wrappers run their plain twins and count nothing.

Usage:
    python -m mola_lidar_odometry_tpu_torch.apps.profile_stages [--batch 1] [--repeats 20]
    python -m mola_lidar_odometry_tpu_torch.apps.profile_stages --device cpu --raw 4096 --icp-cap 512 \\
        --map-cap 2048 --slots 4096 --repeats 2
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

from mola_lidar_odometry_tpu_torch.utils.tree import clone

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..")
DECIMATE_VOXEL = 0.35
RANGE = (1.8, 72.0)
TWIST = (8.0, 0.0, 0.0, 0.0, 0.0, 0.2)
MAP_K, MAP_VOXEL = 20, 0.8
PRUNE_DISTANCE = 100.0
NEIGHBORS = 27
ALIGN_ITERATIONS = 10


def kernel_wrappers():
    """The port's kernel wrappers by name, each with its launch counter."""
    from mola_lidar_odometry_tpu_torch.ops import pallas_capture as pc, pallas_icp as pi, pallas_match as pm

    return {"B1": pc.capture_planar, "B2": pc.capture_planar_reselect, "B3": pi.align_fused, "B4": pm.nn_select}


def timeit(fn, device, repeats: int = 20, warmup: int = 2):
    """(seconds per call over ``repeats`` calls after ``warmup`` calls,
    kernel launches per call in the timed calls)."""
    from mola_lidar_odometry_tpu_torch.apps.trace_step import synchronize

    wrappers = kernel_wrappers()
    for _ in range(warmup):
        fn()
    synchronize(device)
    before = {k: w.launches for k, w in wrappers.items()}
    t0 = time.perf_counter()
    for _ in range(repeats):
        fn()
    synchronize(device)
    secs = (time.perf_counter() - t0) / repeats
    return secs, {k: (w.launches - before[k]) / repeats for k, w in wrappers.items() if w.launches > before[k]}


def device_ms(fn, device) -> float:
    """The device time of one call of ``fn``: its kernels, copies and sets
    summed from a ``torch.profiler`` trace (``apps/trace_step.py``)."""
    from mola_lidar_odometry_tpu_torch.apps.trace_step import profile_device

    return profile_device(fn, device)[3] / 1e3


# ---------------------------------------------------------------------------
# inputs and stages (called by the tests beside the JAX script's)
# ---------------------------------------------------------------------------


def make_inputs(raw: int, icp_cap: int, map_cap: int, slots: int, batch: int, device) -> dict:
    """The JAX script's inputs, drawn in its order from ``default_rng(0)``,
    on ``device`` with a leading dimension ``batch``: the raw cloud, the map
    points, the queries, the step's scan; the map after one insert of the
    map points."""
    import torch

    from mola_lidar_odometry_tpu_torch.ops import voxel_hash as vh
    from mola_lidar_odometry_tpu_torch.ops.pointcloud import PointCloud

    rng = np.random.default_rng(0)

    def mb(shape):
        a = torch.from_numpy(rng.uniform(-60, 60, shape).astype(np.float32)).to(device)
        return a.expand((batch,) + a.shape).contiguous()

    raw_pc = PointCloud.from_xyz(mb((raw, 3)))
    map_pts = PointCloud.from_xyz(mb((map_cap, 3)))
    q = mb((icp_cap, 3))
    m = vh.insert(vh.VoxelHashMap.create(slots, MAP_K, MAP_VOXEL, batch, device=device), map_pts)
    return dict(raw_pc=raw_pc, map_pts=map_pts, map=m, q=q, qv=torch.ones(q.shape[:2], dtype=torch.bool, device=device),
                step_xyz=mb((raw, 3)), batch=batch, device=device, raw=raw, icp_cap=icp_cap, map_cap=map_cap,
                slots=slots)


def decimate(inp: dict):
    from mola_lidar_odometry_tpu_torch.ops import filters as F

    return F.decimate_voxels(inp["raw_pc"], DECIMATE_VOXEL, inp["map_cap"])


def by_range(inp: dict):
    from mola_lidar_odometry_tpu_torch.ops import filters as F

    return F.filter_by_range(inp["raw_pc"], *RANGE)[0]


def deskew(inp: dict):
    import torch

    from mola_lidar_odometry_tpu_torch.ops import filters as F

    tw = torch.tensor(TWIST, dtype=torch.float32, device=inp["device"]).expand(inp["batch"], 6)
    return F.deskew(inp["raw_pc"], tw)


def map_insert(inp: dict):
    from mola_lidar_odometry_tpu_torch.ops import voxel_hash as vh

    return vh.insert(clone(inp["map"]), inp["map_pts"])


def map_prune(inp: dict):
    import torch

    from mola_lidar_odometry_tpu_torch.ops import voxel_hash as vh

    center = torch.zeros((inp["batch"], 3), dtype=torch.float32, device=inp["device"])
    return vh.prune_farther_than(clone(inp["map"]), center, PRUNE_DISTANCE)


def query(inp: dict):
    from mola_lidar_odometry_tpu_torch.ops import voxel_hash as vh

    return vh.query_nn(inp["map"], inp["q"], inp["qv"], neighbors=NEIGHBORS)


def gauss_newton(inp: dict):
    """The solve on fixed pairings: each query paired with itself moved by
    5 cm on every axis, 2 inner iterations, no prior."""
    import torch

    from mola_lidar_odometry_tpu_torch.ops.se3 import Pose
    from mola_lidar_odometry_tpu_torch.ops.solver import PairingBlock, PosePrior, solve_gauss_newton_blocks

    q, B, dev = inp["q"], inp["batch"], inp["device"]
    blk = PairingBlock("p2p", q, q + 0.05, torch.zeros_like(q), inp["qv"], 1.0)
    pose, _ = solve_gauss_newton_blocks(Pose.identity((B,), device=dev), [blk], 1.0, PosePrior.none(B, device=dev), 2)
    return pose


def align_config(hook_min_rot: float = 1e9):
    """The JAX script's align: one point-to-point matcher at a fixed 2 m
    threshold, kernel 1.0, 10 iterations forced (no step is small enough to
    stop), the hook on but never firing (capture once), 27 probes.  The JAX
    script leaves ``hook_min_rot`` at 0, which arms the hook's rotation leg
    at a zero threshold: the first step that turns the pose fires it, and
    its "10 iters" align stops after one iteration in both packages.  Here
    the rotation leg is off too (1e9 rad), so the ten iterations run;
    ``hook_min_rot=0.0`` gives the JAX script's setting."""
    from mola_lidar_odometry_tpu_torch.ops import icp
    from mola_lidar_odometry_tpu_torch.utils.expr import Expr

    return icp.IcpConfig(
        matchers=(icp.MatcherCfg(threshold=Expr("2.0"), local_layer="icp"),),
        kernel_param=Expr("1.0"),
        max_iterations=ALIGN_ITERATIONS,
        min_abs_step_trans=0.0,
        min_abs_step_rot=0.0,
        hook_min_trans=1e9,
        hook_min_rot=hook_min_rot,
        nn_neighbors=NEIGHBORS,  # the JAX IcpConfig's default
    )


def align(inp: dict, cfg=None):
    from mola_lidar_odometry_tpu_torch.ops import icp
    from mola_lidar_odometry_tpu_torch.ops.se3 import Pose
    from mola_lidar_odometry_tpu_torch.ops.solver import PosePrior

    B, dev = inp["batch"], inp["device"]
    return icp.align({"localmap": inp["map"]}, {"icp": (inp["q"], inp["qv"])}, Pose.identity((B,), device=dev),
                     PosePrior.none(B, device=dev), cfg or align_config(), {})


def step_program(inp: dict):
    """lidar3d-default at the stage sizes, its carry after a first step on
    the random scan (which builds the map), and that scan."""
    import torch

    from mola_lidar_odometry_tpu_torch.models import step as step_mod
    from mola_lidar_odometry_tpu_torch.models.spec import spec_from_yaml
    from mola_lidar_odometry_tpu_torch.models.step import Scan
    from mola_lidar_odometry_tpu_torch.utils.config import load_yaml_file

    raw, icp_cap, map_cap, B, dev = inp["raw"], inp["icp_cap"], inp["map_cap"], inp["batch"], inp["device"]
    cfg = load_yaml_file(os.path.join(ROOT, "pipelines", "lidar3d-default.yaml"), env={})
    spec = spec_from_yaml(cfg, raw_capacity=raw, map_slots=inp["slots"], layer_capacities={
        "raw": raw, "decimated_for_map_raw": map_cap, "decimated_for_icp_skewed": icp_cap,
        "decimated_for_icp": icp_cap, "decimated_for_map": map_cap})
    step = step_mod.make_step(spec)
    zeros = torch.zeros((B, raw), dtype=torch.float32, device=dev)
    scan = Scan(xyz=inp["step_xyz"], time=zeros, intensity=zeros.clone(),
                ring=torch.zeros((B, raw), dtype=torch.int32, device=dev),
                valid=torch.ones((B, raw), dtype=torch.bool, device=dev),
                stamp=torch.zeros((B,), dtype=torch.float32, device=dev))
    carry, _ = step(step_mod.init_carry(spec, B, dev), scan)  # the first step builds the map
    return step, carry, scan


# ---------------------------------------------------------------------------
# the report
# ---------------------------------------------------------------------------


def _kernels(k: dict) -> str:
    return ", ".join(f"{n} x{v:g}" for n, v in sorted(k.items())) or "none"


def run(args, device, out=sys.stdout) -> list:
    """Times every stage; prints the JAX script's lines with each stage's
    kernels; returns ``[(label, ms, kernels per call)]``."""
    B, raw, icp_cap, map_cap = args.batch, args.raw, args.icp_cap, args.map_cap
    inp = make_inputs(raw, icp_cap, map_cap, args.slots, B, device)
    rows = []

    def stage(label, fn, repeats=args.repeats, note=""):
        secs, k = timeit(fn, device, repeats)
        dev = f"   device {device_ms(fn, device):.3f} ms" if str(device).startswith("cuda") else ""
        rows.append((label, 1e3 * secs, k))
        print(f"{label:<40s}{1e3 * secs:8.2f} ms{note(secs) if note else ''}{dev}   kernels/call: {_kernels(k)}",
              file=out, flush=True)

    stage(f"decimate_voxels raw({raw})->cap {map_cap}:", lambda: decimate(inp))
    stage(f"filter_by_range({raw}):", lambda: by_range(inp))
    stage(f"deskew({raw}):", lambda: deskew(inp))
    stage(f"map insert({map_cap} pts):", lambda: map_insert(inp))
    stage("map prune:", lambda: map_prune(inp))
    stage(f"query_nn({icp_cap} q, {NEIGHBORS}nbr):", lambda: query(inp))
    stage(f"GN solve (2 inner, {icp_cap} pairs):", lambda: gauss_newton(inp))
    stage(f"ICP align {ALIGN_ITERATIONS} iters:", lambda: align(inp).iterations,
          note=lambda s: f"  ({1e3 * s / ALIGN_ITERATIONS:.2f} ms/iter)")
    step, carry, scan = step_program(inp)
    stage("FULL STEP (steady state):", lambda: step(clone(carry), scan)[1].iterations,
          repeats=max(3, args.repeats // 2))
    return rows


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="profile_stages", description="stage-level device timing of the scan step "
                                 "(PyTorch/CUDA engine)")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--repeats", type=int, default=20)
    ap.add_argument("--raw", type=int, default=1 << 17)
    ap.add_argument("--icp-cap", type=int, default=1 << 13)
    ap.add_argument("--map-cap", type=int, default=1 << 16)
    ap.add_argument("--slots", type=int, default=1 << 17)
    ap.add_argument("--device", default="cuda", help="cuda (default; raises without a card) or cpu")
    return ap


def main(argv=None) -> list:
    args = build_parser().parse_args(argv)
    import torch

    if args.device != "cpu" and not torch.cuda.is_available():
        raise SystemExit("profile_stages: no CUDA device visible; pass --device cpu to run on the CPU")
    name = torch.cuda.get_device_name(0) if args.device != "cpu" else "cpu"
    print(f"device: {name}  batch={args.batch}", file=sys.stderr)
    return run(args, args.device)


if __name__ == "__main__":
    main()
