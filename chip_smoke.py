#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line of numbers each:

  1. device  — the card's name and power limit, torch and CUDA versions;
               exits non-zero when no CUDA device is visible;
  2. build   — compiles the port's CUDA kernels from csrc/ (one nvcc per
               source, all at once) and reports the seconds;
  3. kernels — runs every kernel against its plain PyTorch twin on the card.
               First the design parameters of B1, B2 and B3 (launch shape,
               shared memory, B3's cluster size and plane branch, registers
               and spills from nvcc's -Xptxas -v report).  B1, B2 and B3 at
               bench shapes (B=8 instances,
               3072 ICP points, 8 probes, 16 candidates, a 65536-slot K=20
               map filled by the port's insert) against their plain PyTorch
               twins on the card, in the order and with the arguments of one
               align on the main path (capture at an entry pose off the
               answer, phase 1 from iteration 0, reselect, phase 2 resuming
               the iteration count, a weighted prior, the twist hook firing
               for two instances): B1/B2 must match bit for bit, B3 within
               3e-3 on R and t, one iteration and 0.02 quality.  Device
               times come from CUDA-graph replays: B1, B2 and B3 alone
               (arguments packed once); the whole wrapper calls from CUDA
               graphs and issued from Python are printed beside them, B3
               also per iteration of its slowest instance, and B2's bound
               both over the sectors its selection needs (the record's) and
               over whole rows.  B4
               (nn_select) at the dual-map path's shapes (B=8, the sized 3072
               and 6656 ICP points, C=54 candidates from a 27-probe per-voxel
               capture of K=20 and K=10 maps filled by the port's insert, some
               queries with no candidate), and at C=16 with an N that is no
               multiple of 32: must match bit for bit.  Times each;
  4. main    — steps the B=8 fleet of the lidar3d-default pipeline over the
               first 8 scans of the bench's simulated KITTI-like sequence
               (64 x 2048 rays) on the kernels, with the bench's round-5
               sizing; checks mean quality > 0.9, final-pose GT error < 0.20,
               no ICP-layer saturation, and that B1-B3 launched;
  5. dual-map — steps the B=8 fleet of pipelines/extras/lidar3d-dual-map.yaml
               (two point matchers on two hashed-voxel maps, 27 probes, the
               generic align loop on kernel B4) over the first 6 of the same
               scans, with capacities sized by the JAX package's
               utils/capacity.py; checks every frame accepted, mean quality
               > 0.9, final-pose GT error < 0.20, no reported layer saturated,
               collision drops <= 0.1%, and that B4 launched.  Prints
               iterations, launches per step, scans/s and the peak memory.
               Before phases 4 and 5 the port's utils/capacity.py sizes both
               on the same scans (as bench.py does); the sizing must equal
               SIZING and DUALMAP_SIZING, the JAX package's figures;
  6. host    — the host API a user calls, one vehicle (B = 1):
               LidarOdometry.from_yaml_file with capacity auto-sizing over
               instance 0 of phase 4's scans (lidar3d-default, 8 scans), then
               lidar3d-dual-map over the first 6; the same guards as phases
               4-5; the TUM trajectory and simple-map written to a temporary
               directory and read back (8 and 6 poses).  Prints the derived
               capacities, the per-scan wall ms (median after warm-up), the
               host syncs per scan (torch.cuda.set_sync_debug_mode) and the
               launches of B1-B4.  Then lidar3d-default once more with
               SIZING as overrides: flags and layer counts must equal phase
               4's instance 0, poses within 1e-5.  Every kernel call of
               the last scan of each pipeline is recorded (inputs cloned)
               and, after the launch counts are read, held against its plain
               twin at those B = 1 shapes: B1, B2 and B4 bit for bit, B3
               within phase 3's tolerance.  Last lidar3d-ndt, auto-sized,
               over all but the last scan (host syncs per scan counted); its
               NDT local map saved and loaded back through
               utils/serialization.py into a new instance at the same sizes,
               word for word, which steps the last scan within the guards;
               then lidar2d the same way over its 2D scans (below) at the
               explicit sizes, its occupancy map (keys, log-odds and match
               index) saved and reloaded word for word;
  7. ndt     — steps the B=8 fleet of pipelines/lidar3d-ndt.yaml (NDT map,
               point-to-plane beside point-to-point, no kernel of its own)
               over the 8 scans at the sizes the port's utils/capacity.py
               derives (equal to the JAX package's, NDT_SIZING); prints
               device kernels and busy time of the last step, the host syncs
               torch flags in one step and scans/s, and the JAX package's CPU
               figures for the same scans and sizes beside them; the kernel
               calls of the step whose syncs are counted are recorded and
               held against their plain twins at this path's shapes, as in
               phase 6;
  8. extras  — lidar3d-intensity (with utils/sim.py's world intensity) and
               lidar3d-edges at B=8 over the 8 scans at explicit sizes
               (EXTRAS; auto-sizing raises on their filters in both
               packages), the same prints, and a guard that kernel B4
               launched on each path.  Phases 7-8 (and phase 6's ndt) hold
               the mean quality and final-pose GT error within a measured
               spread of the JAX package's CPU figures, and to the bench's
               guards where the JAX run meets them (``reference_guards``);
  9. lidar2d, rgbd — lidar2d at B=8 over the 12 2D scans of the JAX
               package's test_lidar2d_family_parity (720 beams, 30 m, world
               seed 3, 1.5 m/s) at its explicit sizes (LIDAR2D_SIZING): the
               occupancy map with the free-space DDA walk, two pairings per
               point, no kernel; held to the JAX package's CPU figures as in
               phases 7-8; the DDA walk alone timed at the step's shapes and
               its share of the step's device busy time.  rgbd at B=8 over
               the 8 bench scans at explicit sizes (RGBD_SIZING): edges
               through kernel B4 (its recorded calls bit for bit against the
               twin), point-to-plane on the planes map; every frame
               accepted, mean quality above its acceptance gate, GT error
               under the bench's 0.20 (RGBD_GUARDS: no JAX figure at this
               width).
               Last the generic loop's twist-correction rounds:
               lidar3d-dual-map over 4 scans with the rerun thresholds at
               5 mm and 0.1 degree must run at least one round;
 10. surface — the host surface a user starts, in a temporary directory:
               native/libmola_tpu_native.so built with make when missing;
               the 8 bench scans written as a KITTI-layout sequence
               (velodyne/*.bin, times.txt, identity calib.txt, poses/00.txt);
               the port's CLI run in process (apps/cli.py, the body of its
               main) on lidar3d-default pinned to the JAX CLI's default
               capacities (131072 raw points, 262144 slots: mean quality and
               GT error within QUALITY_SPREAD and GT_SPREAD of the JAX
               package's CPU figures, which miss the bench's 0.20) and as a
               user runs it, sized from the first scan, once with the ICP
               logs off and once with
               MP2P_ICP_GENERATE_DEBUG_FILES=1 and decimation 3 (frames 0, 3
               and 6 replayed through kernel B4, 30 iterations each) writing
               TUM, simple-map and local-map outputs: every frame accepted
               and read by the native decoder, mean quality > 0.9,
               final-pose GT error against poses/00.txt < 0.20 (and both
               within the spreads of the JAX package's figures), the sizes and
               poses equal to an in-process LidarOdometry auto-sized by
               itself (poses to 1e-6 m and 1e-6 rad), each log's pairing
               counts 0 at frame 0 and > 0 later; the kernel calls of that
               instance's frames 3 (logged) and 4 held against their twins
               (B1, B2, B4 bit for bit, B3 within phase 3's tolerance) and
               the syncs of frame 3 counted; the simple-map and local map
               converted to MRPT .simplemap and .mm with apps/convert.py and
               read back word for word; the launcher (apps/launcher.py) on
               launchs/lidar_odometry_from_rosbag2.yaml over an MCAP bag of
               the same scans through AsyncLidarOdometry: no drops, every
               frame accepted.  Prints the CLI's ms per scan with the logs
               off and on, the replay's ms per logged frame and the
               launcher's ms per scan.

Then one JSON line describing every kernel (launches summed over phases
4-10), the card's name and power limit, and last the JSON result line.  Any
failure raises and exits non-zero.  It imports nothing of JAX and nothing of
the JAX package.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import subprocess
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_FLOPS = 67e12  # H100 SXM data sheet, float32 outside the tensor cores
BATCH = 8
N_SCANS = 8
SIZING = dict(  # the bench's auto-sizing of this configuration (round 5)
    raw_capacity=1 << 17,
    map_slots=1 << 16,
    layer_capacities={
        "raw": 1 << 17, "decimated_for_map_raw": 11776, "decimated_for_map_by_range": 11776,
        "decimated_for_map_skewed": 11776, "decimated_for_icp_skewed": 3072,
        "decimated_for_map": 11776, "decimated_for_icp": 3072,
    },
    insert_budgets={"localmap": 4096},
)
DUALMAP_SCANS = 6
# Sizing of pipelines/extras/lidar3d-dual-map.yaml for the same scans, by the
# JAX package's utils/capacity.py (host-side float64 dry pass over the first
# scan; printed by eval/port_dualmap_reference.py).
DUALMAP_SIZING = dict(
    raw_capacity=1 << 17,
    map_slots=1 << 17,
    layer_capacities={
        "raw": 1 << 17, "decimated_for_map_raw": 11776, "decimated_for_map_skewed": 11776,
        "decimated_for_icp_skewed": 3072, "decimated_for_icp_near_skewed": 6656,
        "decimated_for_map": 11776, "decimated_for_icp": 3072, "decimated_for_icp_near": 6656,
    },
    insert_budgets={"localmap": 5632, "localmap_far": 5632},
)
# Guards of the dual-map phase: the bench's own (mean quality > 0.9, final-pose
# GT error < 0.20).  The JAX package's CPU run of the same 6 scans with this
# sizing meets them at 0.9945 and 0.1396 (eval/port_dualmap_reference.py --run).
DUALMAP_GUARDS = dict(min_mean_quality=0.9, max_gt_error=0.20)
NDT_PIPE = "lidar3d-ndt.yaml"
# Sizing of pipelines/lidar3d-ndt.yaml for the same 8 scans by the JAX
# package's utils/capacity.py (printed, with JAX_FIGURES, by
# JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_family_ndt.py 8).
NDT_SIZING = dict(
    raw_capacity=1 << 17,
    map_slots=1 << 16,
    layer_capacities={
        "raw": 1 << 17, "decimated_for_map_raw": 11776, "decimated_for_map_by_range": 11776,
        "decimated_for_map_skewed": 11776, "decimated_for_icp_skewed": 3072, "decimated_for_map": 11776,
        "decimated_for_icp": 3072,
    },
    insert_budgets={"localmap": 4096},
)
# The JAX package's figures for phases 7-8: one instance stepped on the CPU
# over the same 8 scans at the same sizes (the command above; lidar3d-intensity
# with the intensities of utils/sim.py::world_intensity).
JAX_FIGURES = {
    "ndt": dict(iterations=[0, 4, 7, 5, 5, 24, 24, 23], final_pose_gt_error=0.09180744737386703,
                quality=[1.0, 0.8132184147834778, 0.8652090430259705, 0.8647170662879944, 0.863701581954956,
                         0.9462909698486328, 0.9425995945930481, 0.95961993932724]),
    "intensity": dict(iterations=[0, 3, 4, 4, 4, 6, 16, 12], final_pose_gt_error=0.2049948275089264,
                      quality=[1.0, 0.9994319677352905, 0.9988607168197632, 0.9938358068466187, 0.9877353310585022,
                               0.9890679121017456, 0.9798352718353271, 0.9896103739738464]),
    "edges": dict(iterations=[0, 3, 5, 4, 7, 6, 6, 15], final_pose_gt_error=0.27800253033638,
                  quality=[1.0, 0.9942655563354492, 0.9938380122184753, 0.9895333647727966, 0.973909318447113,
                           0.9577284455299377, 0.989708423614502, 0.9815371632575989]),
    # JAX_PLATFORMS=cpu PYTHONPATH=.:tests python tests/test_torch_family_lidar2d.py 12
    "lidar2d": dict(iterations=[0, 3, 8, 8, 7, 8, 9, 6, 6, 3, 6, 7], final_pose_gt_error=0.023755770176649094,
                    quality=[1.0, 0.7060703039169312, 0.7875399589538574, 0.7703348994255066, 0.7543859481811523,
                             0.7170111536979675, 0.6898733973503113, 0.6610169410705566, 0.5469697117805481,
                             0.5267175436019897, 0.4726443886756897, 0.4494720995426178]),
    # phase 10: the JAX package's CLI at its default capacities (131072 raw
    # points, 262144 slots) and its LidarOdometry sized from the first scan,
    # over the 8 bench scans as a KITTI sequence
    # (JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_cli.py 8)
    "cli pinned": dict(iterations=[0, 4, 4, 5, 10, 23, 28, 25], final_pose_gt_error=0.22812950611114502,
                       quality=[1.0, 1.0, 0.9980778694152832, 0.9952448606491089, 0.9918699264526367,
                                0.973519504070282, 0.9943073987960815, 0.9852731823921204]),
    "cli derived": dict(iterations=[0, 6, 6, 23, 24, 23, 24, 26], final_pose_gt_error=0.18492481112480164,
                        quality=[1.0, 1.0, 0.9990389347076416, 0.9952448606491089, 0.9923481345176697,
                                 0.97398841381073, 0.9971536993980408, 0.9862232804298401]),
}
# Phase 9 (and phase 6's lidar2d): the 2D scans of the JAX package's
# test_lidar2d_family_parity (tests/test_oracle_parity.py) at its explicit
# sizes.  Its utils/capacity.py derives 16384 slots and 1024-point layers
# from the first scan, the same in both packages, but counts only the insert
# sources' voxels, not the free-space voxels the rays claim: at those sizes
# the JAX package's own run loses its map (mean quality 0.2412, frames 7-11
# rejected, GT error 0.7335; ROADMAP C10).
LIDAR2D_PIPE = "lidar2d.yaml"
LIDAR2D_SCANS = 12
LIDAR2D_SIZING = dict(
    raw_capacity=1 << 11, map_slots=1 << 16,
    layer_capacities={"raw": 1 << 11, "deskewed": 1 << 11, "decimated_pre": 1 << 11, "decimated": 1 << 11},
)
# rgbd over the bench's scans: the capacity derivation has no rule for the
# range-image generator (it raises in both packages), so explicit sizes, the
# derivation's own rule (1.25x the first scan's populations, 512-point
# quanta) over populations the port measured: edges 7413, planes 120745,
# planes_for_map 92046, planes_for_icp 63573, edges_for_map 6946,
# edges_for_icp 5942 (scan 0; scan 7 within 3%).
RGBD_PIPE = "rgbd.yaml"
RGBD_SIZING = dict(
    raw_capacity=1 << 17, map_slots=1 << 16,
    layer_capacities={"raw": 1 << 17, "edges": 9728, "planes": 1 << 17, "edges_for_map": 9216,
                      "edges_for_icp": 8192, "planes_for_map": 115200, "planes_for_icp": 79872},
)
# rgbd's guards: no JAX figure at the bench's width (the JAX package's run
# of it on a CPU was not made: a full-size configuration).  Its quality,
# the paired ratio over both matchers (point-to-plane within 0.40 m), sits
# near 0.28 on these scans (H100, PERF.md section 5), below the bench's 0.9 as on
# ndt: the bound is the pipeline's own acceptance gate (min_icp_goodness)
# on the mean and on every frame, and the bench's GT error bound.
RGBD_GUARDS = dict(min_mean_quality=0.25, max_gt_error=0.20)
# How far the port on the card may read from those figures: about four and
# three times the largest gaps seen on an H100 (PERF.md section 6): mean
# quality 0.0007 (ndt 0.8942-0.8943 against 0.8936) and final-pose GT error
# 0.0030 (ndt 0.0927-0.0948 against 0.0918); intensity and edges read the
# JAX figures to four digits.
QUALITY_SPREAD = 0.003
GT_SPREAD = 0.01


def reference_guards(tag: str, n_scans: int = N_SCANS) -> dict:
    """Guards of a path over its first ``n_scans`` scans: the mean quality
    (scans 1 on) within QUALITY_SPREAD of the JAX package's over the same
    scans and, over all of JAX_FIGURES' scans, the final-pose GT error
    within GT_SPREAD of its; and the bench's guards (mean quality > 0.9,
    GT error < 0.20) where the JAX run meets them.  It misses 0.9 on ndt
    (0.8936) and 0.20 on intensity and edges (0.2050 and 0.2780), and there
    the bound is the JAX figure less or plus its spread."""
    ref = JAX_FIGURES[tag]
    q = float(np.mean(ref["quality"][1:n_scans]))
    g = dict(ref_quality=q, min_mean_quality=0.9 if q > 0.9 else q - QUALITY_SPREAD, max_gt_error=0.20)
    if n_scans == len(ref["quality"]):
        gt = ref["final_pose_gt_error"]
        g.update(ref_gt_error=gt, max_gt_error=0.20 if gt < 0.20 else gt + GT_SPREAD)
    return g


def guard_failures(mean_quality: float, gt_err: float, guards: dict) -> list:
    """What of a path's guards its mean quality and final-pose GT error
    fail: the bounds, and the distances to the JAX figures where the
    guards hold them."""
    failures = []
    if not mean_quality > guards["min_mean_quality"]:
        failures.append(f"mean quality {mean_quality:.4f} <= {guards['min_mean_quality']:.4f}")
    if not gt_err < guards["max_gt_error"]:
        failures.append(f"final-pose GT error {gt_err:.4f} >= {guards['max_gt_error']:.4f}")
    if "ref_quality" in guards and not abs(mean_quality - guards["ref_quality"]) <= QUALITY_SPREAD:
        failures.append(f"mean quality {mean_quality:.4f} is more than {QUALITY_SPREAD} from the JAX package's "
                        f"{guards['ref_quality']:.4f}")
    if "ref_gt_error" in guards and not abs(gt_err - guards["ref_gt_error"]) <= GT_SPREAD:
        failures.append(f"final-pose GT error {gt_err:.4f} is more than {GT_SPREAD} from the JAX package's "
                        f"{guards['ref_gt_error']:.4f}")
    return failures


# Phase 8: the capacity derivation has no rule for the intensity and
# curvature filters (it raises in both packages), so these sizes are
# explicit: the bench's for the layers lidar3d-intensity shares with
# lidar3d-default, and for lidar3d-edges' decimations at 1% and 1.5% of the
# 80 m range room above what they hold (the saturation guard checks it).
EXTRAS = (
    ("intensity", os.path.join("extras", "lidar3d-intensity.yaml"), ("localmap", "localmap_bright"), dict(
        raw_capacity=1 << 17, map_slots=1 << 17,
        layer_capacities={"raw": 1 << 17, "decimated_for_map_raw": 11776, "decimated_for_icp": 3072},
    )),
    ("edges", os.path.join("extras", "lidar3d-edges.yaml"), ("localmap_large_curvature", "localmap_small_curvature"),
     dict(
        raw_capacity=1 << 17, map_slots=1 << 17,
        layer_capacities={"raw": 1 << 17, "decimated_for_map_large_curvature": 8192,
                          "decimated_for_icp_large_curvature": 4096, "decimated_for_map_smaller_curvature": 16384,
                          "decimated_for_icp_smaller_curvature": 8192},
    )),
)


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]


@contextlib.contextmanager
def flagged_syncs(on: bool = True):
    """Collects, while open, the synchronizing CUDA calls torch flags
    (``torch.cuda.set_sync_debug_mode("warn")``); the list fills on exit."""
    import warnings

    import torch

    hits = []
    if not on:
        yield hits
        return
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield hits
        finally:
            torch.cuda.set_sync_debug_mode(0)
    hits.extend(w for w in caught if "synchroniz" in str(w.message))


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean milliseconds per call over ``reps`` calls, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cuda_graph_ms(fn, reps: int, inner: int = 20) -> float:
    """Mean device milliseconds per call of ``fn``: ``inner`` calls are
    captured into a CUDA graph and the graph is replayed, so the host's cost
    of issuing a launch (which exceeds a short kernel's run time) is not
    counted."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    return cuda_ms(graph.replay, reps) / inner


def bound(nbytes: float, flops: float):
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def phase_device():
    import torch

    if not os.path.isdir(os.path.join(HERE, "mola_lidar_odometry_tpu_torch")):
        raise SystemExit("chip_smoke: the port's package mola_lidar_odometry_tpu_torch is not beside this "
                         "script; run it from the root of a checkout of the repo")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device visible; the port's smoke run needs a GPU")
    log(f"device: {card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} visible")


def phase_build():
    from mola_lidar_odometry_tpu_torch.ops import cuda_build

    secs = cuda_build.build_all()
    log(f"build: {secs:.2f} s for csrc/*.cu (nvcc, sm_90a, one process per source)")
    for name, report in sorted(cuda_build.build_log.items()):
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                log(f"build: {name}: {line.strip()}")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain twins
# ---------------------------------------------------------------------------


def kernel_inputs(dev, seed=0, n_query=3072, slots=1 << 16, K=20):
    """A bench-sized fleet map (``slots`` slots, ``K`` points per voxel)
    filled by the port's insert, and per-instance ICP points near the mapped
    surfaces."""
    import torch

    from mola_lidar_odometry_tpu_torch.ops import voxel_hash as vh
    from mola_lidar_odometry_tpu_torch.ops.pointcloud import PointCloud

    rng = np.random.default_rng(seed)
    m = vh.VoxelHashMap.create(slots, K, 1.0, batch=BATCH, device=dev)
    surf = []
    for _ in range(4):  # four 11776-point frames: ground + walls, 80 m around
        g = rng.uniform(-80, 80, (BATCH, 11776, 2)).astype(np.float32)
        z = np.where(rng.random((BATCH, 11776)) < 0.5, 0.0, rng.uniform(0, 6, (BATCH, 11776)))
        xyz = np.concatenate([g, z[..., None]], axis=-1).astype(np.float32)
        xyz[:, 5000:8000, 1] = np.round(xyz[:, 5000:8000, 1] / 10) * 10  # walls
        surf.append(xyz)
        m, _ = vh.insert_stats(m, PointCloud.from_xyz(torch.from_numpy(xyz).to(dev)), budget=4096)
    pick = rng.integers(0, 11776, (BATCH, n_query))
    world = np.take_along_axis(surf[-1], pick[..., None], axis=1)
    local = (world + rng.normal(0, 0.05, world.shape)).astype(np.float32)
    valid = rng.random((BATCH, n_query)) > 0.05
    return m, torch.from_numpy(local).to(dev), torch.from_numpy(valid).to(dev)


B3_TOL = dict(pose=3e-3, iterations=1, quality=0.02)  # the JAX package's kernel gate


def max_err(got, ref) -> float:
    return max(float((g.double() - r.double()).abs().max()) for g, r in zip(got, ref))


def check_align(name, got, ref):
    """B3 against its twin: R and t within 3e-3, iterations within one,
    quality within 0.02, the same hook and convergence flags."""
    err = max_err(got[:2], ref[:2])
    dit = int((got[2] - ref[2]).abs().max())
    dq = float((got[5] - ref[5]).abs().max())
    flags = bool((got[3] == ref[3]).all() and (got[4] == ref[4]).all())
    if not (err < B3_TOL["pose"] and dit <= B3_TOL["iterations"] and dq < B3_TOL["quality"] and flags):
        raise AssertionError(f"{name} vs plain: max |dR|,|dt| {err:.2e}, iterations {dit}, "
                             f"quality {dq:.3f}, same hook/converged flags {flags}")
    return err


def align_case(dev, m, local, valid):
    """The four kernel calls of one main-path align
    (``ops/icp.py::_align_fused_call``) at phase 3's inputs: B1 at an entry
    pose off the answer, B3 phase 1 from iteration 0, B2 at the settled pose,
    B3 phase 2 resuming the iteration count.  Each call's inputs come from
    the plain twins' outputs; returns the arguments and those outputs."""
    import torch

    from mola_lidar_odometry_tpu_torch.ops import pallas_capture as pc, pallas_icp as pi, se3
    from mola_lidar_odometry_tpu_torch.ops.icp import _FUSED_REFRESH_AT

    B = valid.shape[0]
    P = 8
    # The scan's true pose is the identity (up to the 5 cm point noise).  The
    # align enters 7-13 cm and ~0.4 deg away from it; the last two instances
    # enter 28 cm away, so the twist hook (0.15 m, 0.75 deg from the entry
    # pose) stops them.  The prior's mean is a third pose, with information
    # strong enough to pull the answer by more than the pose tolerance.
    xi = torch.tensor([[0.06 + 0.01 * b, -0.04, 0.02, 0.002, -0.003, 0.006] for b in range(B)], device=dev)
    xi[B - 2:, :3] = torch.tensor([0.25, -0.12, 0.03], device=dev)
    entry = se3.se3_exp(xi)
    prior = se3.se3_exp(torch.tensor([0.03, 0.02, 0.0, 0.0, 0.0, 0.0017], device=dev).expand(B, 6))
    info = torch.diag_embed(torch.tensor([2e3, 2e3, 2e3, 1e6, 1e6, 1e6], device=dev).expand(B, 6)).contiguous()
    maxit = 300
    it_ax = torch.arange(maxit, device=dev, dtype=torch.float32)
    ann = torch.clamp(2.0 - 1.5 * it_ax / 30, min=1.0).expand(B, maxit)  # sigma = 1
    thr, kc = (2.0 * ann).contiguous(), (0.5 * ann).contiguous()
    budget = torch.full((B,), maxit, dtype=torch.int32, device=dev)
    statics = dict(min_abs_step_trans=1e-4, min_abs_step_rot=5e-5, hook_min_trans=0.15,
                   hook_min_rot=0.0131, gn_inner=2, hook_ref_R=entry.R, hook_ref_t=entry.t)
    zero = torch.zeros((B,), dtype=torch.int32, device=dev)
    c = dict(P=P, entry=entry, info=info, budget=budget, maxit=maxit, gn_inner=statics["gn_inner"])
    q0 = se3.transform(entry, local).contiguous()
    c["q0"] = q0
    c["args1"] = (m.data, m.voxel_size, m.epoch, q0, P)
    c["kw1"] = dict(K=m.K, stride=m.stride, valid=valid, return_rows=True)
    c["ref1"] = pc.capture_planar_plain(*c["args1"], **c["kw1"])
    b1 = torch.clamp(budget, max=_FUSED_REFRESH_AT)
    c["args3a"] = (tuple(c["ref1"][:4]), local, valid, entry.R, entry.t, prior.R, prior.t, info, thr, kc, b1)
    c["kw3a"] = dict(it0=zero, **statics)
    c["ref3a"] = pi.align_fused_plain(*c["args3a"], **c["kw3a"])
    R1, t1, it1 = c["ref3a"][:3]
    # B2 at the settled pose, keys from the entry-pose queries; then phase 2
    # from phase 1's pose, it0 = it1, the remaining budget, the hook still
    # measured from the entry pose
    q1 = se3.transform(se3.Pose(R1, t1), local).contiguous()
    c["args2"] = (c["ref1"][4], m.voxel_size, m.epoch, q1, q0, P)
    c["kw2"] = dict(K=m.K, stride=m.stride, valid=valid)
    c["ref2"] = pc.capture_planar_reselect_plain(*c["args2"], **c["kw2"])
    c["args3b"] = (tuple(c["ref2"]), local, valid, R1, t1, prior.R, prior.t, info, thr, kc, budget - it1)
    c["kw3b"] = dict(it0=it1, **statics)
    c["ref3b"] = pi.align_fused_plain(*c["args3b"], **c["kw3b"])
    return c


def wrapper_graph_ms(c) -> dict:
    """Device milliseconds per whole wrapper call of B1, B2 and B3 (argument
    packing included; B3 per launch, the mean of its two phases) at the
    inputs of :func:`align_case`, from CUDA-graph replays.  Only the public
    wrappers are called, whose signatures every tree of the port shares, so
    an earlier tree's kernels can be timed the same way: from the root of
    that tree, load this file by its path and call this function (PERF.md
    gives the command)."""
    from mola_lidar_odometry_tpu_torch.ops import pallas_capture as pc, pallas_icp as pi

    def both():
        pi.align_fused(*c["args3a"], **c["kw3a"])
        pi.align_fused(*c["args3b"], **c["kw3b"])

    return {
        "B1": cuda_graph_ms(lambda: pc.capture_planar(*c["args1"], **c["kw1"]), 20),
        "B2": cuda_graph_ms(lambda: pc.capture_planar_reselect(*c["args2"], **c["kw2"]), 20),
        "B3": cuda_graph_ms(both, 10) / 2,
    }


def ptxas_report(source: str, kernel: str) -> str:
    """Registers and spills of each compiled entry whose name holds
    ``kernel``, from nvcc's ``-Xptxas -v`` report of this run's build."""
    from mola_lidar_odometry_tpu_torch.ops import cuda_build

    out, entry, spill = [], None, ""
    for line in cuda_build.build_log.get(source, "").splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "spill stores" in line:
            spill = line.strip().split(",", 1)[1].strip()
        elif "Used" in line and "registers" in line and entry and kernel in entry:
            regs = line.split("Used", 1)[1].split(",")[0].strip()
            rest = entry.split(kernel, 1)[1]  # "ILi4EE..." for a template instance
            tag = f"<{rest[3:rest.index('E')]}>" if rest.startswith("ILi") else ""
            out.append(f"{kernel}{tag}: {regs}, {spill}")
            entry = None
    return "; ".join(out) if out else "not built in this run"


def phase_kernels(dev):
    """Hold each kernel against its plain twin on the card, called as one
    align of the main path calls them (``ops/icp.py::_align_fused_call``);
    returns the per-kernel records (launch counts come from the main path)."""
    import torch

    from mola_lidar_odometry_tpu_torch.ops import pallas_capture as pc, pallas_icp as pi
    from mola_lidar_odometry_tpu_torch.ops.filters import voxel_coords, voxel_hash
    from mola_lidar_odometry_tpu_torch.ops.voxel_hash import neighbor_coords

    m, local, valid = kernel_inputs(dev)
    B, N = valid.shape
    c = align_case(dev, m, local, valid)
    P, npad, C = c["P"], 3072, 2 * c["P"]
    args1, kw1, args2, kw2 = c["args1"], c["kw1"], c["args2"], c["kw2"]
    args3a, kw3a, args3b, kw3b = c["args3a"], c["kw3a"], c["args3b"], c["kw3b"]
    ref1, ref3a, ref2, ref3b = c["ref1"], c["ref3a"], c["ref2"], c["ref3b"]
    q0 = c["q0"]
    geo1, geo2, geo3 = pc.capture_geometry(B, P, npad), pc.reselect_geometry(B, P, npad), pi.align_geometry(npad, C)
    log(f"kernels: B1 design: one thread per (instance, probe, query), {geo1.threads} threads per block, "
        f"grid {geo1.grid}, {geo1.smem_bytes} B static shared memory per block (32 staged rows per warp); "
        f"{ptxas_report('capture', 'capture_gather_kernel')}")
    log(f"kernels: B2 design: one thread per (instance, probe, query), {geo2.threads} threads per block, "
        f"grid {geo2.grid}, no shared memory; the W way-header sectors, then the selected way's live words; "
        f"{ptxas_report('capture', 'reselect_kernel')}")
    log(f"kernels: B3 design: a cluster of {geo3.cluster} CTAs per instance ({B * geo3.cluster} CTAs), "
        f"{geo3.threads} threads x {geo3.ppt} point(s) on a {geo3.slice}-point slice, {geo3.smem_bytes} B "
        f"dynamic shared memory per CTA, planes read from {'shared' if geo3.planes_in_smem else 'global'} "
        f"memory; {ptxas_report('align', 'align_kernel')}")

    got1 = pc.capture_planar(*args1, **kw1)
    torch.cuda.synchronize()
    for g, r, name in zip(got1, ref1, ("cx", "cy", "cz", "cm", "rows")):
        if not torch.equal(g, r):
            raise AssertionError(f"B1 {name} differs from its plain twin in {int((g != r).sum())} elements")
    err1 = max_err(got1, ref1)
    paired = float(got1[3][:, :P].sum()) / float(valid.sum())
    log(f"kernels: B1 bit-exact vs plain on {B}x{P}x{npad} probes (max |d| {err1}); {paired:.3f} "
        f"probed voxels with a candidate per valid query")

    got3a = pi.align_fused(*args3a, **kw3a)
    torch.cuda.synchronize()
    err3 = check_align("B3 phase 1", got3a, ref3a)
    it1, hook1 = ref3a[2], ref3a[3]

    got2 = pc.capture_planar_reselect(*args2, **kw2)
    torch.cuda.synchronize()
    for g, r, name in zip(got2, ref2, ("cx", "cy", "cz", "cm")):
        if not torch.equal(g, r):
            raise AssertionError(f"B2 {name} differs from its plain twin in {int((g != r).sum())} elements")
    err2 = max_err(got2, ref2)
    log(f"kernels: B2 bit-exact vs plain (max |d| {err2})")

    got3b = pi.align_fused(*args3b, **kw3b)
    torch.cuda.synchronize()
    err3 = max(err3, check_align("B3 phase 2", got3b, ref3b))

    # what the comparison can see: the correction each instance made, the
    # prior's pull, and both exits of the loop
    entry, budget, t1 = c["entry"], c["budget"], ref3a[1]
    need2 = ~hook1 & (budget > it1)
    t_fin = torch.where(need2[:, None], ref3b[1], t1)
    corr_t = (t_fin - entry.t).norm(dim=-1)
    noprior = pi.align_fused(*args3a[:7], torch.zeros_like(c["info"]), *args3a[8:], **kw3a)
    pull = float((noprior[1] - got3a[1]).norm(dim=-1).min())
    log(f"kernels: B3 within tolerance of plain in both phases: max |dR|,|dt| {err3:.3e}; "
        f"iterations phase 1 {it1.tolist()}, phase 2 {ref3b[2].tolist()}; hook {hook1.tolist()}; "
        f"correction |dt| {[round(float(x), 4) for x in corr_t]} m; prior pull >= {pull:.4f} m")
    if not (bool(hook1[B - 2:].all()) and bool(need2[: B - 2].all())):
        raise AssertionError("B3 check: the hook must stop the far entries and only them")
    if not (float(corr_t[: B - 2].min()) > 10 * B3_TOL["pose"] and pull > 3 * B3_TOL["pose"]):
        raise AssertionError("B3 check: corrections or the prior's pull too small for the tolerance")

    # times at these shapes (plain twins once or twice: they are slow); B3
    # per launch, as the mean of the two phases
    def both(fn):
        return lambda: (fn(*args3a, **kw3a), fn(*args3b, **kw3b))

    # Device times from CUDA-graph replays (the host's cost of issuing a
    # launch from Python, which varies between calls, is not counted): each
    # kernel alone (arguments checked and packed once).  The whole wrapper
    # calls are timed from CUDA graphs too (the measure that compares with
    # earlier trees) and issued from Python (the host's share).
    launch1 = pc.capture_launcher(*args1, **kw1)[0]
    launch2 = pc.reselect_launcher(*args2, **kw2)[0]
    launch3 = [pi.align_launcher(geo3, *a, **k)[0] for a, k in ((args3a, kw3a), (args3b, kw3b))]
    ms1 = cuda_graph_ms(launch1, 20)
    call_ms1 = cuda_ms(lambda: pc.capture_planar(*args1, **kw1), 20, 3)
    pms1 = cuda_ms(lambda: pc.capture_planar_plain(*args1, **kw1), 2)
    wms = wrapper_graph_ms(c)
    ms2 = cuda_graph_ms(launch2, 20)
    call_ms2 = cuda_ms(lambda: pc.capture_planar_reselect(*args2, **kw2), 20, 3)
    pms2 = cuda_ms(lambda: pc.capture_planar_reselect_plain(*args2, **kw2), 2)
    ms3 = cuda_graph_ms(lambda: [launch() for launch in launch3], 10) / 2
    call_ms3 = cuda_ms(both(pi.align_fused), 10, 2) / 2
    pms3 = cuda_ms(both(pi.align_fused_plain), 1, 0) / 2

    # bounds from this run's inputs: bytes each input read once / each output
    # written once; B1's table input counts the distinct rows it probes, B2's
    # rows the 32-byte sectors its selection needs (the whole rows beside)
    vs = m.voxel_size.view(B, 1, 1)
    qp = torch.nn.functional.pad(q0, (0, 0, 0, npad - N))
    buckets = voxel_hash(neighbor_coords(qp, voxel_coords(qp, vs), vs, P), m.data.shape[1])
    NB = m.data.shape[1]
    vm = torch.nn.functional.pad(valid, (0, npad - N))
    spread = (torch.arange(npad, device=dev)[:, None] * P + torch.arange(P, device=dev)) % NB
    rows_read = torch.where(vm[..., None], buckets.long(), spread)
    uniq_rows = int(torch.unique(rows_read + torch.arange(B, device=dev).view(B, 1, 1) * NB).numel())
    q_bytes = B * N * 3 * 4 + B * N
    planes = 4 * B * C * npad * 4
    rows = B * P * npad * 512
    flops_sel = B * P * npad * 32 * 20  # 32 lanes x ~20 flops of dequantize + distance
    b1 = bound(uniq_rows * 512 + q_bytes + planes + rows, flops_sel)
    b2_rows = bound(rows + 2 * q_bytes + planes, flops_sel)
    sectors, words = pc.reselect_sectors(args2[0], m.voxel_size, m.epoch, q0, P, m.K, m.stride)
    b2 = bound(sectors * 32 + 2 * q_bytes + planes, (words + 2 * B * P * npad) * 20)
    it_total = int(ref3a[2].sum() + ref3b[2].sum() + 2 * B)  # + each launch's quality pass
    flops3 = it_total * npad * (C * 9 + 18 + c["gn_inner"] * 45)
    b3 = bound(2 * (B * N * 13 + planes + 2 * B * c["maxit"] * 4 + B * 16 * 4), flops3)
    b3 = (b3[0] / 2, b3[1])
    card = torch.cuda.get_device_name(0)
    for name, ms, pms, bd in (("B1", ms1, pms1, b1), ("B2", ms2, pms2, b2), ("B3", ms3, pms3, b3)):
        log(f"kernels: {name} {ms:.4f} ms (plain {pms:.3f} ms, bound {bd[0]:.4f} ms by {bd[1]}) "
            f"on {card}")
    # a launch lasts as long as its slowest instance: per iteration of that one
    it_max = int(ref3a[2].max()) + int(ref3b[2].max())
    log(f"kernels: B3 {ms3:.4f} ms per launch, {2 * ms3 / it_max * 1e3:.2f} us per iteration "
        f"({it_max} iterations of the slowest instance over the two phases, quality passes included)")
    log(f"kernels: B2 bounds: {b2[0]:.4f} ms by {b2[1]} over the {sectors} sectors its selection needs "
        f"({sectors * 32 / 1e6:.2f} MB of rows, {words} live point words; {100 * b2[0] / ms2:.1f}% of its time), "
        f"{b2_rows[0]:.4f} ms by {b2_rows[1]} over whole rows ({rows / 1e6:.2f} MB; {100 * b2_rows[0] / ms2:.1f}%)")
    log(f"kernels: whole wrapper calls (kernel + argument packing) from CUDA graphs: B1 {wms['B1']:.4f} ms, "
        f"B2 {wms['B2']:.4f} ms, B3 {wms['B3']:.4f} ms per launch; issued from Python: B1 {call_ms1:.4f} ms, "
        f"B2 {call_ms2:.4f} ms, B3 {call_ms3:.4f} ms per launch")
    recs = [
        dict(name="capture_planar", route="cuda", source="mola_lidar_odometry_tpu_torch/csrc/capture.cu",
             replaces="mola_lidar_odometry_tpu/ops/pallas_capture.py:257", max_abs_err=err1,
             ms=ms1, plain_ms=pms1, bound_ms=b1[0], bound_by=b1[1], library_ms=None,
             wrapper=pc.capture_planar),
        dict(name="capture_planar_reselect", route="cuda", source="mola_lidar_odometry_tpu_torch/csrc/capture.cu",
             replaces="mola_lidar_odometry_tpu/ops/pallas_capture.py:335", max_abs_err=err2,
             ms=ms2, plain_ms=pms2, bound_ms=b2[0], bound_by=b2[1], library_ms=None,
             wrapper=pc.capture_planar_reselect),
        dict(name="align_fused", route="cuda", source="mola_lidar_odometry_tpu_torch/csrc/align.cu",
             replaces="mola_lidar_odometry_tpu/ops/pallas_icp.py:542", max_abs_err=err3,
             ms=ms3, plain_ms=pms3, bound_ms=b3[0], bound_by=b3[1], library_ms=None,
             wrapper=pi.align_fused),
    ]
    return recs


def phase_kernel_match(dev):
    """Hold kernel B4 (``nn_select``) against its plain twin on the card at
    the dual-map path's shapes, as one align of that path calls it: a
    27-probe per-voxel capture at an entry pose off the answer, then the
    select at the entry pose and at the answer.  Returns B4's record."""
    import torch

    from mola_lidar_odometry_tpu_torch.ops import pallas_match as pm, se3, voxel_hash as vh

    caps = DUALMAP_SIZING["layer_capacities"]
    slots = DUALMAP_SIZING["map_slots"]
    shapes = [  # (label, map K, N, probes)
        ("decimated_for_icp -> localmap", 20, caps["decimated_for_icp"], 27),
        ("decimated_for_icp_near -> localmap_far", 10, caps["decimated_for_icp_near"], 27),
        ("8 probes, N = 3001", 20, 3001, 8),
    ]
    pair, err = [], 0.0  # the two selects of one dual-map iteration, for the timing
    for label, K, N, P in shapes:
        m, local, _ = kernel_inputs(dev, seed=K + P, n_query=N, slots=slots, K=K)
        local = local.clone()
        local[:, ::31, 2] += 30.0  # points far above the map: no candidate at all
        xi = torch.tensor([[0.06 + 0.01 * b, -0.04, 0.02, 0.002, -0.003, 0.006] for b in range(BATCH)], device=dev)
        q_entry = se3.transform(se3.se3_exp(xi), local).contiguous()
        planar = pm.to_planar(vh.capture(m, q_entry, P, per_voxel_nn=True))
        C = planar.mask.shape[-1]
        if C != 2 * P or planar.x.shape != (BATCH, N, C):
            raise AssertionError(f"B4 {label}: planes {tuple(planar.x.shape)}, expected {(BATCH, N, 2 * P)}")
        n_none = 0
        for queries in (q_entry, local.contiguous()):
            got, ref = pm.nn_select(planar, queries), pm.nn_select_plain(planar, queries)
            torch.cuda.synchronize()
            for g, r, name in zip(got, ref, ("target", "d2min")):
                if not torch.equal(g + 0.0, r + 0.0):
                    raise AssertionError(f"B4 {label}: {name} differs from its plain twin in "
                                         f"{int((g != r).sum())} elements")
            n_none += int((got[1] > 1e37).sum())
            err = max(err, max_err(got, ref))
        if n_none == 0:
            raise AssertionError(f"B4 {label}: the inputs must hold queries with no candidate")
        log(f"kernels: B4 bit-exact vs plain on {BATCH}x{N}x{C} ({label}; max |d| {err}); "
            f"{n_none} selects found no candidate")
        if P == 27:
            pair.append((planar, q_entry))
    # Timed as one iteration of the dual-map align calls it: the select over
    # the first matcher's planes, then over the second's (together larger
    # than the 50 MB L2, so neither launch finds its planes cached); ms and
    # bound are per launch, the mean of the two.  The kernel is shorter than
    # the host's cost of one launch from Python, so its time is taken from a
    # CUDA graph of the launches; the eager figure is printed beside it.
    def select_both():
        for p, q in pair:
            pm.nn_select(p, q)

    ms = cuda_graph_ms(select_both, 20) / 2
    eager_ms = cuda_ms(select_both, 50, 5) / 2
    pms = cuda_ms(lambda: [pm.nn_select_plain(p, q) for p, q in pair], 5, 1) / 2
    # each input read once (4 planes, the queries), the (B, N, 4) output written once
    cells = sum(p.mask.numel() for p, _ in pair)
    rows = sum(q.shape[0] * q.shape[1] for _, q in pair)
    bd = bound((cells * 16 + rows * (12 + 16)) / 2, cells * 9 / 2)
    sizes = " and ".join("x".join(map(str, p.mask.shape)) for p, _ in pair)
    log(f"kernels: B4 {ms:.4f} ms per launch over {sizes} in turn ({eager_ms:.4f} ms issued from Python, "
        f"plain {pms:.3f} ms, bound {bd[0]:.4f} ms by {bd[1]}) on {torch.cuda.get_device_name(0)}")
    return dict(name="nn_select", route="cuda", source="mola_lidar_odometry_tpu_torch/csrc/match.cu",
                replaces="mola_lidar_odometry_tpu/ops/pallas_match.py:109", max_abs_err=err, ms=ms,
                plain_ms=pms, bound_ms=bd[0], bound_by=bd[1], library_ms=None, wrapper=pm.nn_select)


# ---------------------------------------------------------------------------
# phases 4 and 5: the two paths — the B=8 fleet over the bench's scans
# ---------------------------------------------------------------------------


def bench_scans(n: int):
    """The first ``n`` scans of the bench's sequence (bench.py:47-57): the
    same world, trajectory, sensor model and seeds."""
    from mola_lidar_odometry_tpu_torch.utils import sim

    world = sim.make_world(0, extent=60.0, n_boxes=100, n_plates=50)
    traj = sim.make_trajectory(n, dt=0.1, seed=1, speed=8.0)
    scans = [
        sim.simulate_scan(
            world, traj.R[k], traj.t[k], traj.twists[k], n_rings=64, n_azimuth=2048,
            fov_up_deg=3.0, fov_down_deg=-24.0, spin_period=0.1, noise=0.01, max_range=80.0,
            seed=1000 + k,
        )
        for k in range(n)
    ]
    return scans, traj


LAST_PROFILE = {}  # the figures of the last profiled step


def profile_step(fstep, carry, scan):
    """One fleet step under torch.profiler: wall time, device-busy time and
    the device kernels that take the most of it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        carry, out = fstep(carry, scan)
        torch.cuda.synchronize()
        wall = (time.time() - t0) * 1e3

    def dev_us(e):
        return getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)

    # device-side events only (kernels, copies, sets); the aten:: entries
    # carry the same device time again
    evs = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    busy = sum(dev_us(e) for e in evs) / 1e3
    n_kernels = sum(e.count for e in evs)
    log(f"profile: last step {wall:.2f} ms wall (profiled), device busy {busy:.3f} ms "
        f"({100 * busy / wall:.1f}%), {n_kernels} device kernels/copies")
    LAST_PROFILE.update(wall_ms=wall, busy_ms=busy, device_ops=n_kernels)
    ranked = sorted(evs, key=dev_us, reverse=True)
    own = ("capture_gather_kernel", "reselect_kernel", "align_kernel", "nn_select_kernel")  # wherever they rank
    for e in ranked[:12] + [e for e in ranked[12:] if any(k in e.key for k in own)]:
        log(f"profile:   {dev_us(e) / 1e3:8.3f} ms  x{e.count:<5d} {e.key[:90]}")
    return carry, out


def run_fleet(dev, recs, tag, pipeline, sizing, scans, traj, guards, map_names, count_syncs=False, params=None):
    """Step the B=8 fleet of ``pipeline`` through ``scans`` on the kernels
    with every launch count set to 0 just before and read just after;
    returns (scans/s, launches of this path per kernel name, outputs, the
    last carry).
    With ``count_syncs`` the step before the profiled last one counts the
    host syncs torch flags and records its kernel calls (and is left out of
    the rate); after the counts are read, each recorded call is held
    against its plain twin at this path's own shapes.  ``params`` are
    set in the pipeline's ``params`` block."""
    import torch

    from mola_lidar_odometry_tpu_torch.models import step as step_mod
    from mola_lidar_odometry_tpu_torch.models.spec import spec_from_yaml
    from mola_lidar_odometry_tpu_torch.parallel import batch as pb
    from mola_lidar_odometry_tpu_torch.utils.config import load_yaml_file

    n_scans = len(scans)
    cfg = load_yaml_file(os.path.join(HERE, "pipelines", pipeline), env={})
    cfg["params"].update(params or {})
    spec = spec_from_yaml(cfg, kf_ring_capacity=256, **sizing)
    fstep = pb.make_fleet_step(spec)
    seq = [pb.pack_scans(spec, [s] * BATCH, [traj.stamps[k]] * BATCH, device=dev) for k, s in enumerate(scans)]
    carry = pb.init_fleet_carry(spec, BATCH, device=dev)
    # the layers' buffer widths, from the step's own filter pass (no kernel runs in it)
    widths = {name: pc.valid.shape[1] for name, pc in step_mod.filter_scan(spec, carry, seq[0])[2].items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    for r in recs:
        r["wrapper"].launches = 0
    outs, secs, syncs, calls = [], [], None, []
    for k in range(n_scans - 1):
        counted = count_syncs and k == n_scans - 2
        with flagged_syncs(counted) as hits, recording(recs, calls) if counted else contextlib.nullcontext():
            t1 = time.time()
            carry, out = fstep(carry, seq[k])
            torch.cuda.synchronize()
        if counted:
            syncs = len(hits)
        else:
            secs.append(time.time() - t1)
        outs.append(out)
    carry, out = profile_step(fstep, carry, seq[-1])  # the last frame, under the profiler
    outs.append(out)
    launches = {r["name"]: r["wrapper"].launches for r in recs}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    q = torch.stack([o.quality for o in outs]).cpu().numpy()
    accepted = torch.stack([o.accepted for o in outs]).cpu().numpy()
    nicp = torch.stack([o.n_icp_layer for o in outs]).cpu().numpy()
    nmap = torch.stack([o.n_map_layer for o in outs]).cpu().numpy()
    drops = int(torch.stack([o.map_collision_drops for o in outs]).sum())
    iters = torch.stack([o.iterations for o in outs]).cpu().numpy()
    corr = int(torch.stack([o.corrections for o in outs]).sum())
    gt_err = gt_error(traj, n_scans - 1, carry.pose_R[0].cpu(), carry.pose_t[0].cpu())
    icp_cap = widths[spec.icp_local_layer]
    map_cap = widths[spec.map_inserts[0].input_layer]
    warm = 2  # frame 0 seeds the map, frame 1 is the first ICP on it
    sps = BATCH * len(secs[warm:]) / sum(secs[warm:])
    card = torch.cuda.get_device_name(0)
    log(f"{tag}: per-step seconds {[round(s, 4) for s in secs]}")
    log(f"{tag}: mean quality (frames > 0) {q[1:].mean():.4f}; iterations per frame {iters[:, 0].tolist()}; "
        f"twist corrections {corr}; final-pose GT error {gt_err:.4f}; icp layer max {int(nicp.max())}/{icp_cap}; "
        f"map layer max {int(nmap.max())}/{map_cap}; collision drops {drops}/{int(nmap.sum())} "
        f"over {len(map_names)} map(s)")
    log(f"{tag}: {sps:.2f} scans/s over frames {warm}..{len(secs) - 1} (B={BATCH}) on {card}; "
        f"peak device memory {peak_gb:.3f} GB")
    log(f"{tag}: launches " + ", ".join(f"{k}={v} ({v / n_scans:.2f}/step)" for k, v in launches.items()))
    if syncs is not None:
        log(f"{tag}: host syncs flagged by torch in step {n_scans - 2}: {syncs} (that step is left out of the rate)")
    failures = guard_failures(float(q[1:].mean()), gt_err, guards)
    if not accepted[1:].all():
        failures.append(f"frames not accepted: {np.argwhere(~accepted).tolist()}")
    if not nicp.max() < icp_cap:
        failures.append(f"{spec.icp_local_layer} saturated ({int(nicp.max())})")
    if not nmap.max() < map_cap:
        failures.append(f"{spec.map_inserts[0].input_layer} saturated ({int(nmap.max())})")
    if drops > 1e-3 * nmap.sum():  # the drops of every map against one map's points: stricter than per map
        failures.append(f"collision drops {drops} > 0.1% of {int(nmap.sum())}")
    if sorted(carry.maps) != sorted(map_names):
        failures.append(f"map layers {sorted(carry.maps)} != {sorted(map_names)}")
    failures += [f"{k} never launched on the {tag} path" for k in guards["kernels"] if launches[k] <= 0]
    if failures:
        raise AssertionError(f"{tag}: " + "; ".join(failures))
    if count_syncs:
        check_recorded(tag, calls, guards["kernels"])
    return sps, launches, outs, carry


MAIN_KERNELS = ("capture_planar", "capture_planar_reselect", "align_fused")
DUALMAP_KERNELS = ("nn_select",)
MAIN_GUARDS = dict(min_mean_quality=0.9, max_gt_error=0.20)
DUALMAP_PIPE = os.path.join("extras", "lidar3d-dual-map.yaml")


def phase_sizing(scans):
    """Size phases 4, 5 and 7 with the port's utils/capacity.py as bench.py
    does (the first scan's dry pass, the raw buffer fitted to the largest
    scan of the path) and hold the result against SIZING, DUALMAP_SIZING
    and NDT_SIZING, the JAX package's figures."""
    from mola_lidar_odometry_tpu_torch.models.spec import spec_from_yaml
    from mola_lidar_odometry_tpu_torch.utils.capacity import derive_capacities
    from mola_lidar_odometry_tpu_torch.utils.config import load_yaml_file

    x0, t0, _, v0 = scans[0]
    for tag, pipe, n, want in (("main", "lidar3d-default.yaml", N_SCANS, SIZING),
                               ("dual-map", DUALMAP_PIPE, DUALMAP_SCANS, DUALMAP_SIZING),
                               ("ndt", NDT_PIPE, N_SCANS, NDT_SIZING)):
        spec = spec_from_yaml(load_yaml_file(os.path.join(HERE, "pipelines", pipe), env={}))
        max_pts = max(int(v.sum()) for _, _, _, v in scans[:n])
        got = derive_capacities(spec, x0[v0], t0[v0], with_budgets=True, known_max_points=max_pts)
        got = dict(zip(("raw_capacity", "map_slots", "layer_capacities", "insert_budgets"), got))
        log(f"sizing: {tag}: port {json.dumps(got)}")
        log(f"sizing: {tag}: JAX  {json.dumps(want)}")
        if got != want:
            raise AssertionError(f"sizing: {tag}: the port's derive_capacities differs from the JAX package's")


def gt_error(traj, k, R, t) -> float:
    """Gauge-aligned SE(3) log-norm error of pose k (relative to frame 0)."""
    import torch

    from mola_lidar_odometry_tpu_torch.ops import se3

    def G(i):
        return se3.Pose(torch.tensor(traj.R[i], dtype=torch.float32), torch.tensor(traj.t[i], dtype=torch.float32))

    est = se3.Pose(torch.as_tensor(R, dtype=torch.float32), torch.as_tensor(t, dtype=torch.float32))
    return float(torch.linalg.norm(se3.se3_log(se3.relative(se3.relative(G(0), G(k)), est))))


def _clone(x):
    """``x`` with every tensor in it (in tuples, named tuples, lists and
    dicts) cloned."""
    import torch

    if torch.is_tensor(x):
        return x.clone()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_clone(v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(_clone(v) for v in x)
    if isinstance(x, dict):
        return {k: _clone(v) for k, v in x.items()}
    return x


class _Recorder:
    """Stands in for a kernel's wrapper in its module: appends (record,
    args, kwargs), its tensors cloned, to ``calls`` and calls the wrapper.
    ``launches`` is the wrapper's own count (a wrapper counts through its
    module-level name, which now names this object)."""

    def __init__(self, wrapper, rec, calls):
        self._w, self._r, self._calls = wrapper, rec, calls

    def __call__(self, *a, **k):
        self._calls.append((self._r, _clone(a), _clone(k)))
        return self._w(*a, **k)

    @property
    def launches(self):
        return self._w.launches

    @launches.setter
    def launches(self, n):
        self._w.launches = n


@contextlib.contextmanager
def recording(recs, calls):
    """While open, each kernel's wrapper is replaced in its module by a
    :class:`_Recorder`: the main path's own calls at its own shapes."""
    import importlib

    saved = []
    for r in recs:
        w = r["wrapper"]
        mod = importlib.import_module(w.__module__)
        saved.append((mod, w.__name__, w))
        setattr(mod, w.__name__, _Recorder(w, r, calls))
    try:
        yield calls
    finally:
        for mod, name, w in saved:
            setattr(mod, name, w)


def check_recorded(tag, calls, kernels):
    """Each kernel call recorded from a path against its plain twin on the
    same inputs, at the path's own shapes: B1, B2 and B4 bit for bit, B3
    within ``B3_TOL``.  Raises the record's ``max_abs_err`` to the largest
    error seen."""
    import torch

    from mola_lidar_odometry_tpu_torch.ops import pallas_capture as pc, pallas_icp as pi, pallas_match as pm

    plain = {"capture_planar": pc.capture_planar_plain, "capture_planar_reselect": pc.capture_planar_reselect_plain,
             "align_fused": pi.align_fused_plain, "nn_select": pm.nn_select_plain}
    done = {}
    for r, a, k in calls:
        name = r["name"]
        got, ref = r["wrapper"](*a, **k), plain[name](*a, **k)
        torch.cuda.synchronize()
        if name == "align_fused":
            err = check_align(f"{tag}: B3 at the path's shapes", got, ref)
        else:
            for i, (g, w) in enumerate(zip(got, ref)):
                if not torch.equal(g, w):
                    raise AssertionError(f"{tag}: {name} output {i} at the path's shapes differs from its "
                                         f"plain twin in {int((g != w).sum())} elements")
            err = max_err(got, ref)
        r["max_abs_err"] = max(r["max_abs_err"], err)
        n, e, shapes = done.get(name, (0, 0.0, set()))
        done[name] = (n + 1, max(e, err), shapes | {"x".join(map(str, got[0].shape))})
    for name, (n, e, shapes) in done.items():
        log(f"{tag}: {name} vs plain over {n} recorded call(s), outputs {sorted(shapes)}: "
            f"{'within tolerance' if name == 'align_fused' else 'bit-exact'}, max |d| {e:.3g}")
    missing = [k for k in kernels if k not in done]
    if missing:
        raise AssertionError(f"{tag}: no call of {missing} recorded")


def run_host(dev, tag, pipe, scans, traj, guards, count_syncs=False, record=None, **overrides):
    """One vehicle through ``LidarOdometry`` (the user's entry point), with
    the same guards as phases 4-5.  With ``count_syncs`` every synchronizing
    CUDA call warns (``torch.cuda.set_sync_debug_mode``) and is counted per
    scan and, for the last scan, per call site.  ``record``, a context
    manager, is open around the last scan.  Returns (the instance, the host
    outputs, wall seconds per scan, syncs per scan, call sites)."""
    import collections

    from mola_lidar_odometry_tpu_torch.models.odometry import LidarOdometry

    lo = LidarOdometry.from_yaml_file(os.path.join(HERE, "pipelines", pipe), env={}, device=dev,
                                      kf_ring_capacity=256, **overrides)
    outs, secs, syncs, sites = [], [], [], collections.Counter()
    for k, (xyz, times, rings, valid) in enumerate(scans):
        last = k == len(scans) - 1
        with record if record is not None and last else contextlib.nullcontext(), flagged_syncs(count_syncs) as hits:
            t1 = time.time()
            outs.append(lo.on_lidar_scan(xyz[valid], traj.stamps[k], times=times[valid], ring=rings[valid]))
            secs.append(time.time() - t1)
        syncs.append(len(hits))
        if last:
            sites.update(f"{os.path.relpath(w.filename, HERE)}:{w.lineno}" for w in hits)
    spec = lo.spec
    q = np.array([float(o.quality) for o in outs])
    accepted = np.array([bool(o.accepted) for o in outs])
    nicp = max(int(o.n_icp_layer) for o in outs)
    nmap = max(int(o.n_map_layer) for o in outs)
    icp_cap = spec.layer_capacities[spec.icp_local_layer]
    map_cap = spec.layer_capacities[spec.map_inserts[0].input_layer]
    err = gt_error(traj, len(scans) - 1, outs[-1].pose_R, outs[-1].pose_t)
    log(f"{tag}: iterations per scan {[int(o.iterations) for o in outs]}; mean quality (scans > 0) "
        f"{q[1:].mean():.4f}; final-pose GT error {err:.4f}; icp layer max {nicp}/{icp_cap}; "
        f"map layer max {nmap}/{map_cap}")
    failures = guard_failures(float(q[1:].mean()), err, guards)
    if not accepted[1:].all():
        failures.append(f"scans not accepted: {np.flatnonzero(~accepted).tolist()}")
    if not (nicp < icp_cap and nmap < map_cap):
        failures.append(f"a layer saturated (icp {nicp}/{icp_cap}, map {nmap}/{map_cap})")
    if failures:
        raise AssertionError(f"{tag}: " + "; ".join(failures))
    return lo, outs, secs, syncs, sites


def check_fma(dev):
    """The port rounds its rotations as fused multiply-adds
    (``se3.fma_f32``: ``torch.addcmul`` on CUDA, an exact emulation on the
    CPU); hold the card's against the emulation on 2^20 triples, a quarter
    of them on float32 halfway points."""
    import torch

    from mola_lidar_odometry_tpu_torch.ops import se3

    rng = np.random.default_rng(9)
    n = 1 << 20
    a, b = (rng.normal(0, 1, n).astype(np.float32) for _ in range(2))
    c = (rng.normal(0, 1, n) * 10.0 ** rng.integers(-9, 9, n)).astype(np.float32)
    p32 = (a.astype(np.float64) * b).astype(np.float32)
    c[: n // 4] = -p32[: n // 4] + (np.spacing(p32[: n // 4]) / 2).astype(np.float32)
    t = [torch.from_numpy(x) for x in (a, b, c)]
    got = se3.fma_f32(*(x.to(dev) for x in t)).cpu()
    want = se3.fma_f32_emulated(*t)
    bad = int((got != want).sum())
    log(f"host: fused multiply-add on the card (torch.addcmul) vs the exact emulation: {bad} of {n} differ "
        f"({int((want != t[0] * t[1] + t[2]).sum())} differ from the unfused a * b + c)")
    if bad:
        raise AssertionError("se3.fma_f32 on the card is not the exactly rounded multiply-add")


def phase_host(dev, recs, scans, traj, main_outs):
    """Phase 6: the host API on the card, one vehicle; returns each kernel's
    launches in this phase."""
    import tempfile

    import torch

    from mola_lidar_odometry_tpu_torch.models.spec import SimpleMapCfg
    from mola_lidar_odometry_tpu_torch.utils import serialization, tum

    card = torch.cuda.get_device_name(0)
    check_fma(dev)
    keep_all = SimpleMapCfg(generate=True, add_non_keyframes_too=True)  # a simple-map entry per scan
    for r in recs:
        r["wrapper"].launches = 0
    warm = 2  # scan 0 sizes the buffers and seeds the map, scan 1 is the first ICP on it
    recorded = []  # (tag, kernel calls of the last scan, the path's kernels)
    for tag, pipe, n, guards, kernels in (
        ("host", "lidar3d-default.yaml", N_SCANS, MAIN_GUARDS, MAIN_KERNELS),
        ("host dual-map", DUALMAP_PIPE, DUALMAP_SCANS, DUALMAP_GUARDS, DUALMAP_KERNELS),
    ):
        before = {r["name"]: r["wrapper"].launches for r in recs}
        lo, outs, secs, _, _ = run_host(dev, tag, pipe, scans[:n], traj, guards, simplemap=keep_all)
        here = {r["name"]: r["wrapper"].launches - before[r["name"]] for r in recs}
        spec = lo.spec
        log(f"{tag}: derived capacities raw={spec.raw_capacity} slots={[d.num_slots for d in spec.map_layers]} "
            f"layers={json.dumps(spec.layer_capacities)} budgets={[d.insert_budget for d in spec.map_layers]}")
        med = float(np.median(secs[warm:])) * 1e3
        spans = {k: 1e3 * float(np.median(lo.profiler.times(f"onLidar.{k}")[warm:])) for k in ("pad", "step", "readback")}
        log(f"{tag}: per-scan wall ms {[round(1e3 * s, 2) for s in secs]}; median over scans {warm}..{n - 1} "
            f"{med:.2f} ms ({1e3 / med:.1f} scans/s, B=1) on {card}; of it (medians) " +
            ", ".join(f"{k} {v:.2f} ms" for k, v in spans.items()))
        log(f"{tag}: launches " + ", ".join(f"{k}={v} ({v / n:.2f}/scan)" for k, v in here.items()))
        never = [k for k in kernels if here[k] <= 0]
        if never:
            raise AssertionError(f"{tag}: {never} never launched")
        with tempfile.TemporaryDirectory() as tmp:
            lo.save_trajectory_tum(os.path.join(tmp, "traj.tum"))
            lo.save_simplemap(os.path.join(tmp, "map.simplemap"))
            stamps, _, _ = tum.load_tum(os.path.join(tmp, "traj.tum"))
            sm = serialization.load_simplemap(os.path.join(tmp, "map.simplemap"))
        log(f"{tag}: TUM trajectory {len(stamps)} poses, simple-map {len(sm)} keyframes "
            f"({sum(kf.scan_xyz is not None for kf in sm)} with their scan), read back")
        if len(stamps) != n or len(sm) != n:
            raise AssertionError(f"{tag}: wrote {len(stamps)} poses and {len(sm)} keyframes, expected {n}")
        # the same scans again, counting the host syncs (the warnings cost
        # time) and recording the last scan's kernel calls (cloning costs time)
        calls = []
        _, _, _, syncs, sites = run_host(dev, f"{tag} (syncs)", pipe, scans[:n], traj, guards, count_syncs=True,
                                         record=recording(recs, calls))
        recorded.append((tag, calls, kernels))
        log(f"{tag}: host syncs per scan {syncs}; last scan's by call site: " +
            ", ".join(f"{k} x{v}" for k, v in sites.most_common()))

    # the fixed sizing of phase 4 through the host API: instance 0 of phase 4
    _, outs, secs, _, _ = run_host(dev, "host fixed sizing", "lidar3d-default.yaml", scans, traj, MAIN_GUARDS, **SIZING)
    fields = ("processed", "accepted", "kf_local", "kf_simplemap", "n_raw", "n_icp_layer", "n_map_layer",
              "corrections", "iterations", "map_collision_drops", "map_full_drops", "deferred_drops")
    worst = 0.0
    for k, (o, ref) in enumerate(zip(outs, main_outs)):
        for f in fields:
            want = getattr(ref, f)[0].cpu().numpy()
            if not np.array_equal(getattr(o, f), want):
                raise AssertionError(f"host fixed sizing: {f} at scan {k}: {getattr(o, f)} != phase 4's {want}")
        for f in ("pose_R", "pose_t"):
            worst = max(worst, float(np.abs(getattr(o, f) - getattr(ref, f)[0].cpu().numpy()).max()))
    log(f"host fixed sizing: flags and layer counts equal phase 4's instance 0 over {len(outs)} scans; "
        f"largest pose difference {worst:.3g} (limit 1e-5); median {1e3 * float(np.median(secs[warm:])):.2f} ms "
        f"per scan")
    if not worst <= 1e-5:
        raise AssertionError(f"host fixed sizing: pose differs from phase 4's instance 0 by {worst}")
    launches = {r["name"]: r["wrapper"].launches for r in recs}
    for tag, calls, kernels in recorded:  # after the counts are read: these launches do not count
        check_recorded(tag, calls, kernels)
    return launches


def phase_ndt(dev, recs, scans, traj):
    """Phase 7: lidar3d-ndt at B = 8 over the bench's scans, beside the JAX
    package's CPU figures for the same scans and sizes."""
    guards = reference_guards("ndt")
    _, launches, _, _ = run_fleet(dev, recs, "ndt", NDT_PIPE, NDT_SIZING, scans, traj, dict(guards, kernels=()),
                               ("localmap",), count_syncs=True)
    print_reference("ndt", guards)
    return launches


def print_reference(tag: str, guards: dict) -> None:
    ref = JAX_FIGURES[tag]
    log(f"{tag}: the JAX package on the CPU (one instance, the same scans and sizes): iterations per frame "
        f"{ref['iterations']}, mean quality {guards['ref_quality']:.4f}, final-pose GT error "
        f"{ref['final_pose_gt_error']:.4f}; this phase's guards: mean quality > {guards['min_mean_quality']:.4f} "
        f"and within {QUALITY_SPREAD} of the JAX figure, GT error < {guards['max_gt_error']:.4f} and within "
        f"{GT_SPREAD} of it")


def phase_extras(dev, recs, scans, traj):
    """Phase 8: lidar3d-intensity and lidar3d-edges at B = 8 over the
    bench's scans at explicit sizes; both pair through kernel B4."""
    from mola_lidar_odometry_tpu_torch.utils import sim

    total = {r["name"]: 0 for r in recs}
    for tag, pipe, map_names, sizing in EXTRAS:
        seq = scans
        if tag == "intensity":  # the simulated scans have no intensity of their own
            seq = [s + (sim.world_intensity(traj, k, s[0]),) for k, s in enumerate(scans)]
        guards = reference_guards(tag)
        _, launches, _, _ = run_fleet(dev, recs, tag, pipe, sizing, seq, traj, dict(guards, kernels=DUALMAP_KERNELS),
                                   map_names, count_syncs=True)
        print_reference(tag, guards)
        for k, v in launches.items():
            total[k] += v
    return total


def _tensors(x):
    """Every tensor in ``x`` (nested tuples, named tuples and dicts), in order."""
    import torch

    if torch.is_tensor(x):
        return [x]
    if isinstance(x, dict):
        return [t for k in sorted(x) for t in _tensors(x[k])]
    if isinstance(x, tuple):
        return [t for v in x for t in _tensors(v)]
    return []


def phase_host_reload(dev, tag, pipe, scans, traj, guards, min_quality, **overrides):
    """Phase 6 on a pipeline with a map class of its own (lidar3d-ndt,
    lidar2d): the host API at B = 1 over all but the last scan (auto-sized
    unless ``overrides`` size it); its local map saved and loaded back
    through utils/serialization.py into a new instance at the same sizes,
    word for word, which steps the last scan from the pose the first
    reached: accepted, quality above ``min_quality``, GT error within the
    guards."""
    import tempfile

    import torch

    from mola_lidar_odometry_tpu_torch.models.odometry import LidarOdometry

    warm = 2
    lo, outs, secs, syncs, sites = run_host(dev, tag, pipe, scans[:-1], traj, guards, count_syncs=True, **overrides)
    spec = lo.spec
    log(f"{tag}: capacities raw={spec.raw_capacity} slots={[d.num_slots for d in spec.map_layers]} "
        f"layers={json.dumps(spec.layer_capacities)}")
    log(f"{tag}: per-scan wall ms (sync counting on) {[round(1e3 * x, 2) for x in secs]}; median over scans "
        f"{warm}.. {1e3 * float(np.median(secs[warm:])):.2f} ms on {torch.cuda.get_device_name(0)}; host syncs per "
        f"scan {syncs}; last scan's by call site: " + ", ".join(f"{k} x{v}" for k, v in sites.most_common()))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "local.mm")
        lo.save_local_map(path)
        sizes = dict(raw_capacity=spec.raw_capacity, map_slots=spec.map_layers[0].num_slots,
                     layer_capacities=spec.layer_capacities)
        lo2 = LidarOdometry.from_yaml_file(os.path.join(HERE, "pipelines", pipe), env={}, device=dev,
                                           kf_ring_capacity=256, **sizes)
        lo2.load_local_map(path)
    a, b = _tensors(lo2.carry.maps), _tensors(lo.carry.maps)
    same = len(a) == len(b) and all(x.shape == y.shape and torch.equal(x, y) for x, y in zip(a, b))
    lo2.relocalize_near_pose_pdf(outs[-1].pose_R, outs[-1].pose_t)
    k = len(scans) - 1
    xyz, times, rings, valid = scans[k]
    out = lo2.on_lidar_scan(xyz[valid], traj.stamps[k], times=times[valid], ring=rings[valid])
    err = gt_error(traj, k, out.pose_R, out.pose_t)
    m = lo2.carry.maps[spec.map_layers[0].name]
    log(f"{tag}: local map saved and loaded back ({'word for word' if same else 'DIFFERS'}, {len(a)} tensors, "
        f"{int(m.num_voxels()[0])} voxels); scan {k} from the loaded map: accepted {bool(out.accepted)}, quality "
        f"{float(out.quality):.4f} (bound {min_quality:.4f}), {int(out.iterations)} iterations, GT error {err:.4f}")
    if not (same and bool(out.accepted) and float(out.quality) > min_quality and err < guards["max_gt_error"]):
        raise AssertionError(f"{tag}: the reloaded local map did not step the next scan within the guards")


def lidar2d_scans(n: int):
    """The 2D scans of the JAX package's test_lidar2d_family_parity: a
    720-beam horizontal ring, 30 m range, 0.1 s spin, world seed 3 (extent
    25 m, 40 boxes, 30 plates), planar motion at 1.5 m/s at z = 0.3."""
    from mola_lidar_odometry_tpu_torch.utils import sim

    world = sim.make_world(3, extent=25.0, n_boxes=40, n_plates=30)
    traj = sim.make_trajectory(n, dt=0.1, seed=4, speed=1.5, z=0.3)
    scans = [
        sim.simulate_scan(world, traj.R[k], traj.t[k], traj.twists[k], n_rings=1, n_azimuth=720, fov_up_deg=0.0,
                          fov_down_deg=0.0, spin_period=0.1, max_range=30.0, seed=50 + k)
        for k in range(n)
    ]
    return scans, traj


def dda_share(dev, scans, traj):
    """The occupancy insert's DDA walk alone at the lidar2d step's shapes
    (B = 8, the decimated layer of the last scan, 512 steps): its device
    ops and device busy time under the profiler, their shares of the last
    profiled step's (the step inserts on every frame, masked), and its
    elapsed time by CUDA events (bound by the host issuing its ops)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mola_lidar_odometry_tpu_torch.models import step as step_mod
    from mola_lidar_odometry_tpu_torch.models.spec import spec_from_yaml
    from mola_lidar_odometry_tpu_torch.ops import occupancy
    from mola_lidar_odometry_tpu_torch.parallel import batch as pb
    from mola_lidar_odometry_tpu_torch.utils.config import load_yaml_file

    busy = LAST_PROFILE["busy_ms"]
    spec = spec_from_yaml(load_yaml_file(os.path.join(HERE, "pipelines", LIDAR2D_PIPE), env={}), **LIDAR2D_SIZING)
    seq = pb.pack_scans(spec, [scans[-1]] * BATCH, [traj.stamps[-1]] * BATCH, device=dev)
    pc = step_mod.filter_scan(spec, pb.init_fleet_carry(spec, BATCH, device=dev), seq)[2]["decimated"]
    origin = torch.zeros((BATCH, 3), device=dev)
    vs = torch.full((BATCH,), 0.05, device=dev)
    d = spec.map_layers[0]

    def walk():
        return occupancy._dda_voxels(origin, pc.xyz, pc.valid, vs, d.max_ray_samples)

    ms = cuda_ms(walk, reps=3)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        walk()
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    ops = sum(e.count for e in evs)
    dbusy = sum(getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0) for e in evs) / 1e3
    n_ops = LAST_PROFILE["device_ops"]
    log(f"lidar2d: DDA walk alone ({d.max_ray_samples} steps over B={BATCH} x {pc.valid.shape[1]} beams, "
        f"{int(pc.count()[0])} valid): device busy {dbusy:.3f} ms in {ops} device ops, {100 * dbusy / busy:.1f}% of "
        f"the last step's device busy {busy:.3f} ms and {100 * ops / n_ops:.1f}% of its {n_ops} device ops; "
        f"{ms:.3f} ms elapsed per walk (CUDA events: the host issuing the ops)")


def phase_lidar2d_rgbd(dev, recs, scans, traj):
    """Phase 9: lidar2d at B = 8 over its 2D scans (the occupancy map, two
    pairings per point: no kernel), held to the JAX package's CPU figures;
    rgbd at B = 8 over the bench's scans (point-to-point on the edges map
    through kernel B4, point-to-plane on the planes map), the B4 calls of
    one step held bit for bit against the twin; then the generic loop's
    twist-correction rounds on the card: lidar3d-dual-map over 4 scans with
    the rerun thresholds at 5 mm and 0.1 degree (the recipe of
    ``tests/test_torch_step_corrections.py``, whose 2 cm the bench's slow
    start stays under: the vehicle moves 1.5 cm between its first two
    scans).  Returns each kernel's launches."""
    total = {r["name"]: 0 for r in recs}
    s2d, traj2d = lidar2d_scans(LIDAR2D_SCANS)
    guards = reference_guards("lidar2d", LIDAR2D_SCANS)
    _, launches, outs, _ = run_fleet(dev, recs, "lidar2d", LIDAR2D_PIPE, LIDAR2D_SIZING, s2d, traj2d,
                                     dict(guards, kernels=()), ("localmap",), count_syncs=True)
    print_reference("lidar2d", guards)
    dda_share(dev, s2d, traj2d)
    for tag, pipe, sizing, seq, guards, maps, params in (
        ("rgbd", RGBD_PIPE, RGBD_SIZING, scans, RGBD_GUARDS, ("localmap_edges", "localmap_planes"), None),
        ("corrections", DUALMAP_PIPE, DUALMAP_SIZING, scans[:4], DUALMAP_GUARDS, ("localmap", "localmap_far"),
         dict(optimize_twist_rerun_min_trans=0.005, optimize_twist_rerun_min_rot_deg=0.1)),
    ):
        l, outs, _ = run_fleet(dev, recs, tag, pipe, sizing, seq, traj, dict(guards, kernels=DUALMAP_KERNELS), maps,
                               count_syncs=tag == "rgbd", params=params)[1:]
        for k, v in l.items():
            total[k] += v
    corr = [int(o.corrections.max()) for o in outs]
    log(f"corrections: most twist-correction rounds of an instance per frame {corr}")
    if not max(corr) > 0:
        raise AssertionError("corrections: no twist-correction round ran on the card")
    return {k: total[k] + launches[k] for k in total}


# ---------------------------------------------------------------------------
# phase 10: the host surface — the CLI on a KITTI layout, MRPT files, the
# launcher on an MCAP bag
# ---------------------------------------------------------------------------

SURFACE_KERNELS = MAIN_KERNELS + DUALMAP_KERNELS  # B1-B3 in the CLI's step, B4 in its ICP-log replay


@contextlib.contextmanager
def environ(**kv):
    """``os.environ`` with ``kv`` set (``None`` unsets a name) while open."""
    def put(items):
        for k, v in items:
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = str(v)

    saved = [(k, os.environ.get(k)) for k in kv]
    put(kv.items())
    try:
        yield
    finally:
        put(saved)


@contextlib.contextmanager
def step_outputs(outs):
    """While open, the host output of every ``LidarOdometry.on_lidar_scan``
    (the CLI's own, inside its loop) is appended to ``outs``."""
    from mola_lidar_odometry_tpu_torch.models.odometry import LidarOdometry

    orig = LidarOdometry.on_lidar_scan

    def spy(self, *a, **k):
        outs.append(orig(self, *a, **k))
        return outs[-1]

    LidarOdometry.on_lidar_scan = spy
    try:
        yield outs
    finally:
        LidarOdometry.on_lidar_scan = orig


def build_native():
    """The repo's native host library (KITTI .bin decode), built from
    ``native/`` with its Makefile when it is missing; returns the binding."""
    from mola_lidar_odometry_tpu_torch.utils import native

    if not native.available():
        t0 = time.time()
        subprocess.run(["make", "-C", os.path.join(HERE, "native")], check=True, capture_output=True)
        native._TRIED = False  # probe again
        log(f"surface: built native/libmola_tpu_native.so in {time.time() - t0:.1f} s")
    if not native.available():
        raise AssertionError("surface: the native library did not build")
    return native


def write_kitti(root, scans, traj):
    """A KITTI-layout sequence 00 of ``scans``: velodyne/*.bin (x, y, z,
    intensity f32 of the valid points), times.txt, an identity calib.txt
    and poses/00.txt from the trajectory."""
    seq = os.path.join(root, "sequences", "00")
    os.makedirs(os.path.join(seq, "velodyne"))
    os.makedirs(os.path.join(root, "poses"))
    for k, (xyz, _, _, valid) in enumerate(scans):
        pts = np.zeros((int(valid.sum()), 4), np.float32)
        pts[:, :3] = xyz[valid]
        pts.tofile(os.path.join(seq, "velodyne", f"{k:06d}.bin"))
    with open(os.path.join(seq, "times.txt"), "w") as f:
        f.writelines(f"{traj.stamps[k]:.6f}\n" for k in range(len(scans)))
    with open(os.path.join(seq, "calib.txt"), "w") as f:
        f.write("Tr: 1 0 0 0 0 1 0 0 0 0 1 0\n")
    with open(os.path.join(root, "poses", "00.txt"), "w") as f:
        for k in range(len(scans)):
            T = np.concatenate([traj.R[k], traj.t[k][:, None]], axis=1)
            f.write(" ".join(f"{v:.9f}" for v in T.reshape(-1)) + "\n")


def tum_gap(a, b):
    """Largest translation (m) and rotation (rad) difference between two
    TUM files' poses, row by row (float64; the rotation angle by the stable
    2 atan2(|qa - qb|, |qa + qb|))."""
    from mola_lidar_odometry_tpu_torch.utils import tum

    (sa, ta, qa), (sb, tb, qb) = tum.load_tum(a), tum.load_tum(b)
    if len(sa) != len(sb) or not np.array_equal(sa, sb):
        raise AssertionError(f"surface: {a} and {b} hold other stamps")
    qb = qb * np.sign(np.sum(qa * qb, axis=1, keepdims=True))
    ang = 2 * np.arctan2(np.linalg.norm(qa - qb, axis=1), np.linalg.norm(qa + qb, axis=1))
    return float(np.abs(ta - tb).max()), float(ang.max())


def gt_error_tum(est_path, gt_path) -> float:
    """Gauge-aligned SE(3) log-norm error of the last pose of a TUM file
    against a ground-truth TUM file (relative to its first pose)."""
    import torch

    from mola_lidar_odometry_tpu_torch.ops import se3
    from mola_lidar_odometry_tpu_torch.utils import tum

    (_, te, qe), (_, tg, qg) = tum.load_tum(est_path), tum.load_tum(gt_path)

    def P(t, q):
        f = lambda a: torch.as_tensor(np.asarray(a, np.float32))  # noqa: E731
        return se3.Pose(se3.quat_to_rot(f(q)), f(t))

    rel = se3.relative(se3.relative(P(tg[0], qg[0]), P(tg[-1], qg[-1])), P(te[-1], qe[-1]))
    return float(torch.linalg.norm(se3.se3_log(rel)))


def phase_surface(dev, recs, scans, traj):
    """Phase 10: the host surface on the card (see the module docstring);
    returns each kernel's launches in this phase (the CLI run with the ICP
    logs on, and the launcher)."""
    import tempfile

    import torch

    from mola_lidar_odometry_tpu_torch.apps import cli, convert, datasets as D, launcher
    from mola_lidar_odometry_tpu_torch.models.odometry import LidarOdometry
    from mola_lidar_odometry_tpu_torch.utils import mcap, serialization as S, tum

    card = torch.cuda.get_device_name(0)
    native = build_native()
    pipe = os.path.join(HERE, "pipelines", "lidar3d-default.yaml")
    n, warm = len(scans), 2
    launches = {r["name"]: 0 for r in recs}

    def count(fn):
        for r in recs:
            r["wrapper"].launches = 0
        out = fn()
        for r in recs:
            launches[r["name"]] += r["wrapper"].launches
        return out

    def med_ms(lo, span, first=warm):
        return 1e3 * float(np.median(lo.profiler.times(span)[first:]))

    with tempfile.TemporaryDirectory() as tmp:
        write_kitti(tmp, scans, traj)
        base = ["-c", pipe, "--input-kitti-seq", "00", "--kitti-correction-angle-deg", "0", "-v", "ERROR",
                "--device", dev]
        outs = [os.path.join(tmp, x) for x in ("cli.tum", "cli.simplemap.npz", "cli.mm.npz")]
        full = base + ["--output-tum-path", outs[0], "--output-simplemap", outs[1], "--output-local-map", outs[2]]
        for d in ("default", "off", "inproc"):
            os.makedirs(os.path.join(tmp, d))
        with environ(KITTI_BASE_DIR=tmp, MP2P_ICP_GENERATE_DEBUG_FILES=None):
            # pinned to the JAX CLI's default capacities
            pinned_outs = []
            with contextlib.chdir(os.path.join(tmp, "default")), step_outputs(pinned_outs):
                lo_def = cli.run(base + ["--raw-capacity", str(1 << 17), "--map-slots", str(1 << 18),
                                         "--output-tum-path", os.path.join(tmp, "default.tum")])
            with contextlib.chdir(os.path.join(tmp, "off")):
                lo_off = cli.run(base + ["--output-tum-path", os.path.join(tmp, "off.tum")])
            with environ(MP2P_ICP_GENERATE_DEBUG_FILES=1, MP2P_ICP_LOG_FILES_DECIMATION=3), contextlib.chdir(tmp):
                decodes = native.decode_bin.calls
                cli_outs = []
                with step_outputs(cli_outs):
                    lo = count(lambda: cli.run(full))
                decodes = native.decode_bin.calls - decodes
                # the same dataset frames into an in-process instance, auto-sized
                # by LidarOdometry itself, with the logs on; its kernel calls of
                # a logged and an ordinary frame are recorded
                ds = D.KittiOdometryDataset("00", vertical_angle_correction_deg=0.0)
                calls, syncs = [], None
                with contextlib.chdir(os.path.join(tmp, "inproc")):
                    ref = LidarOdometry.from_yaml_file(pipe, device=dev)
                    for i in range(len(ds)):
                        fr = ds.get(i)
                        rec = recording(recs, calls) if i in (3, 4) else contextlib.nullcontext()
                        with rec, flagged_syncs(i == 3) as hits:
                            ref.on_lidar_scan(fr.xyz, fr.stamp, times=fr.times, intensity=fr.intensity, ring=fr.ring)
                        if i == 3:
                            syncs = hits
                    ref.save_trajectory_tum(os.path.join(tmp, "inproc.tum"))
        def sizes(spec):
            return (spec.raw_capacity, spec.layer_capacities, [(d.num_slots, d.insert_budget) for d in spec.map_layers])

        q = np.array([float(o.quality) for o in cli_outs])
        gt_err = gt_error_tum(outs[0], outs[0] + ".gt.tum")
        gap = tum_gap(outs[0], os.path.join(tmp, "inproc.tum"))
        gap_off = tum_gap(outs[0], os.path.join(tmp, "off.tum"))
        q_def = np.array([float(o.quality) for o in pinned_outs])
        gt_def = gt_error_tum(os.path.join(tmp, "default.tum"), outs[0] + ".gt.tum")
        guards, guards_def = reference_guards("cli derived"), reference_guards("cli pinned")
        log(f"surface: CLI on a KITTI layout of the {n} bench scans ({len(scans[0][0])} rays, "
            f"{[int(v.sum()) for _, _, _, v in scans]} points), {decodes} decodes by the native library; "
            f"sized from the first scan: raw, layers, (slots, insert budget) {sizes(lo.spec)}; iterations per scan "
            f"{[int(o.iterations) for o in cli_outs]}; mean quality (scans > 0) {q[1:].mean():.4f}; final-pose "
            f"GT error against poses/00.txt {gt_err:.4f}")
        print_reference("cli derived", guards)
        log(f"surface: pinned to the JAX CLI's defaults {sizes(lo_def.spec)}: iterations per scan "
            f"{[int(o.iterations) for o in pinned_outs]}; mean quality (scans > 0) {q_def[1:].mean():.4f}; "
            f"final-pose GT error {gt_def:.4f}")
        print_reference("cli pinned", guards_def)
        log(f"surface: CLI poses against the in-process instance: {gap[0]:.3g} m, {gap[1]:.3g} rad (limit 1e-6); "
            f"against the CLI with the logs off: {gap_off[0]:.3g} m, {gap_off[1]:.3g} rad")
        failures = guard_failures(float(q[1:].mean()), gt_err, guards)
        failures += [f"pinned: {f}" for f in guard_failures(float(q_def[1:].mean()), gt_def, guards_def)]
        if len(pinned_outs) != n or not all(bool(o.accepted) for o in pinned_outs):
            failures.append(f"pinned: frames not all accepted: {[bool(o.accepted) for o in pinned_outs]}")
        if sizes(ref.spec) != sizes(lo.spec):
            failures.append(f"the CLI's derived sizes {sizes(lo.spec)} differ from LidarOdometry's {sizes(ref.spec)}")
        if len(cli_outs) != n or not all(bool(o.accepted) for o in cli_outs) or len(lo.trajectory) != n:
            failures.append(f"frames not all accepted: {[bool(o.accepted) for o in cli_outs]}")
        if decodes != n + 1:  # the first scan is read once more, to size the buffers
            failures.append(f"{decodes} decodes by the native library for {n} frames (+1 to size)")
        if not (gap[0] <= 1e-6 and gap[1] <= 1e-6):
            failures.append(f"the CLI's poses differ from the in-process instance's by {gap}")
        logs = sorted(os.listdir(os.path.join(tmp, "icp-logs")))
        if logs != [f"icp-run-{k:06d}.icplog.npz" for k in (0, 3, 6)]:
            failures.append(f"ICP logs {logs}, expected frames 0, 3 and 6")
        for name in logs:
            d = np.load(os.path.join(tmp, "icp-logs", name))
            first = name.endswith("000000.icplog.npz")
            ok = (not d["paired"].any()) if first else bool((d["paired"] > 0).all())
            ok = ok and "pair_details" in d and all(np.isfinite(d[k]).all() for k in ("poses_R", "poses_t"))
            log(f"surface: {name}: paired {d['paired'][[0, 1, -1]].tolist()} (first, second, last of "
                f"{len(d['paired'])}), quality {float(d['quality']):.4f}, pair details {d['pair_details'].shape}")
            if not ok:
                failures.append(f"{name}: paired {d['paired'].tolist()}")
        if failures:
            raise AssertionError("surface: " + "; ".join(failures))
        replay = [1e3 * x for x in lo.profiler.times("onLidar.icp_log.replay")]
        log(f"surface: CLI ms per scan (median over scans {warm}..{n - 1}, onLidar) {med_ms(lo_off, 'onLidar'):.2f} "
            f"with the ICP logs off, {med_ms(lo, 'onLidar'):.2f} with them on (every 3rd scan logged), "
            f"{med_ms(lo_def, 'onLidar'):.2f} pinned to the JAX CLI's defaults on {card}; "
            f"the replay (30 iterations, B4 once each) {[round(x, 2) for x in replay]} ms per logged frame, "
            f"writing the log {[round(1e3 * x, 2) for x in lo.profiler.times('onLidar.icp_log.write')]} ms")
        log(f"surface: host syncs flagged by torch in logged frame 3: {len(syncs)}; by call site: " + ", ".join(
            f"{k} x{v}" for k, v in collections.Counter(
                f"{os.path.relpath(w.filename, HERE)}:{w.lineno}" for w in syncs).most_common()))

        # MRPT files: the simple-map and the local map through convert, read back
        sm, mm = os.path.join(tmp, "cli.simplemap"), os.path.join(tmp, "cli.mm")
        if convert.main([outs[1], sm]) != 0 or convert.main([outs[2], mm, "--device", dev]) != 0:
            raise AssertionError("surface: convert failed")
        kfs, back = S.load_simplemap(outs[1]), S.import_simplemap_mrpt(sm)
        same_sm = len(kfs) == len(back) > 0 and all(
            np.array_equal(a.t, b.t) and np.array_equal(a.quat_xyzw, b.quat_xyzw)
            and (a.scan_xyz is None) == (b.scan_xyz is None)
            and (a.scan_xyz is None or np.array_equal(a.scan_xyz.astype(np.float32), b.scan_xyz))
            for a, b in zip(kfs, back))
        want = S.metric_map_points(S.load_metric_map(outs[2], device=dev))
        got = S.import_metric_map_mrpt(mm)
        same_mm = sorted(got) == sorted(want) and all(
            np.array_equal(got[k].view(np.int32), want[k].view(np.int32)) for k in got)
        log(f"surface: MRPT files: {len(back)} keyframes in cli.simplemap ({sum(b.scan_xyz is not None for b in back)} "
            f"with their scan), {', '.join(f'{k} {len(v)} points' for k, v in got.items())} in cli.mm; read back "
            f"{'word for word' if same_sm and same_mm else 'DIFFERENT'}")
        if not (same_sm and same_mm):
            raise AssertionError("surface: the MRPT files do not read back word for word")

        # the launcher on the repo's rosbag2 launch file, over an MCAP bag
        bag = os.path.join(tmp, "bench.mcap")
        mcap.write_pointcloud2_mcap(bag, [
            (float(traj.stamps[k]) + 1.0, xyz[valid], dict(times=times[valid], ring=rings[valid].astype(np.uint16)))
            for k, (xyz, times, rings, valid) in enumerate(scans)])
        os.makedirs(os.path.join(tmp, "results"))
        with environ(MOLA_INPUT_ROSBAG2=bag, MOLA_ODOMETRY_PIPELINE_YAML=pipe,
                     MP2P_ICP_GENERATE_DEBUG_FILES=None), contextlib.chdir(tmp):
            llo, rt = count(lambda: launcher.launch(os.path.join(HERE, "launchs", "lidar_odometry_from_rosbag2.yaml"),
                                                    device=dev))
        stamps, _, _ = tum.load_tum(os.path.join(tmp, "results", "rosbag2.tum"))
        log(f"surface: launcher (launchs/lidar_odometry_from_rosbag2.yaml, AsyncLidarOdometry): "
            f"{llo.frames_processed} frames processed, {len(llo.trajectory)} accepted, {rt.dropped_observations} "
            f"dropped, {len(stamps)} poses in results/rosbag2.tum; {med_ms(llo, 'onLidar'):.2f} ms per scan "
            f"(median over scans {warm}..{n - 1}, onLidar) on {card}")
        if rt.dropped_observations or rt.fatal_error or len(llo.trajectory) != n or len(stamps) != n:
            raise AssertionError("surface: the launcher dropped or rejected frames")
    log("surface: launches " + ", ".join(f"{k}={v}" for k, v in launches.items()))
    never = [k for k in SURFACE_KERNELS if launches[k] <= 0]
    if never:
        raise AssertionError(f"surface: {never} never launched")
    check_recorded("surface: CLI frames 3 (logged) and 4", calls, SURFACE_KERNELS)
    return launches


def phase_paths(dev, recs):
    """Phases 4-10 over the bench's simulated sequence (and lidar2d's 2D
    scans); fills ``launches`` of every record with the sum over them."""
    t0 = time.time()
    scans, traj = bench_scans(N_SCANS)
    log(f"main: simulated {N_SCANS} scans of {len(scans[0][0])} rays in {time.time() - t0:.1f} s (host)")
    phase_sizing(scans)
    _, main_l, main_outs, _ = run_fleet(
        dev, recs, "main", "lidar3d-default.yaml", SIZING, scans, traj, dict(MAIN_GUARDS, kernels=MAIN_KERNELS),
        ("localmap",),
    )
    _, dual_l, _, _ = run_fleet(
        dev, recs, "dual-map", DUALMAP_PIPE, DUALMAP_SIZING,
        scans[:DUALMAP_SCANS], traj, dict(DUALMAP_GUARDS, kernels=DUALMAP_KERNELS), ("localmap", "localmap_far"),
    )
    host_l = phase_host(dev, recs, scans, traj, main_outs)
    phase_host_reload(dev, "host ndt", NDT_PIPE, scans, traj, reference_guards("ndt", N_SCANS - 1),
                      reference_guards("ndt", N_SCANS - 1)["min_mean_quality"])
    s2d, traj2d = lidar2d_scans(LIDAR2D_SCANS)
    # the reloaded instance has no motion prior (as after a relocalization):
    # its scan is held to the JAX package's quality for that frame less 0.1
    phase_host_reload(dev, "host lidar2d", LIDAR2D_PIPE, s2d, traj2d, reference_guards("lidar2d", LIDAR2D_SCANS - 1),
                      JAX_FIGURES["lidar2d"]["quality"][-1] - 0.1, **LIDAR2D_SIZING)
    ndt_l = phase_ndt(dev, recs, scans, traj)
    extra_l = phase_extras(dev, recs, scans, traj)
    l9 = phase_lidar2d_rgbd(dev, recs, scans, traj)
    l10 = phase_surface(dev, recs, scans, traj)
    for r in recs:
        r["launches"] = sum(ls[r["name"]] for ls in (main_l, dual_l, host_l, ndt_l, extra_l, l9, l10))
        del r["wrapper"]
    never = [r["name"] for r in recs if r["launches"] <= 0]
    if never:
        raise AssertionError(f"kernels never launched on any path: {never}")


def main():
    import torch

    phase_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    recs = phase_kernels("cuda")
    recs.append(phase_kernel_match("cuda"))
    phase_paths("cuda", recs)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in recs]}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
