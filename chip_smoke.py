#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --only-point-axis    # phases 1, 2 and 12 (the four-card NCCL run)
    python3 chip_smoke.py --only-tools         # phases 1, 2 and 13
    python3 chip_smoke.py --only-full-voxel    # phases 1, 2 and the full-voxel parts of 3, 11 and 13 (c)
    python3 chip_smoke.py --only-dispatch      # phases 1, 2 and the ICP dispatch's parts of 3, 11 and 12

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
               multiple of 32: must match bit for bit.  Times each.  Then
               B1 and B2 bit for bit at the windows past 32 points the
               fused path admits (K = 30 at stride 32, a full window; K = 64
               and 126 at stride 128), on a map filled until the probed
               voxels hold K points, each time beside its bound.  Last B4
               bit for bit at the full-voxel widths (per_voxel_nn off:
               every point of each probed voxel, C = P*K): C = 160 over
               lidar3d-default's 8 x 3072 ICP layer (8 probes, K = 20),
               C = 540 and 270 over dual-map's two layers (27 probes, K =
               20 and 10), each timed beside its plain twin and its bound.
               Then the rest of the ICP dispatch: B3 on candidates from
               the plain per-voxel capture (handed to its wrapper as a
               CandSet) over a K = 200 map (stride 256, the probed voxels
               filled past 126 points), lidar3d-default's 8 x 3072 ICP
               layer, phase 1 at C = 16 and the fresh 4-probe refresh at
               C = 8, within B3's tolerance; and B1/B2 bit for bit at 4
               and 1 probes; each timed beside its twin and its bound;
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

 11. complete — lidar3d-default at B=8 over the 8 bench scans at the sizes
               the port derives (equal to the JAX package's,
               COMPLETE_SIZING) in the configurations of COMPLETE: 64 points
               per voxel (MOLA_LOCALMAP_MAX_POINTS_PER_VOXEL=64, a 128-lane
               window on the fused path, B1-B3), 200 points per voxel with
               min_distance_between_points 0.2 (a copy of the YAML in a
               temporary directory: a 256-lane window and the dedup on the
               generic loop, B4), and ROADMAP C6's paths on the generic
               loop: the no-motion-model ICP block (Horn, then
               Gauss-Newton), Anderson acceleration of depth 3 and a
               one-to-one matcher; and the full-voxel capture (the JAX
               package's algorithm on every backend but a TPU:
               per_voxel_nn off, the generic loop on B4 at C = P*K) on
               lidar3d-default and on lidar3d-dual-map, where B1-B3 must
               not launch (scans/s, device ops and B4 launches a step,
               peak memory printed).  Last the rest of the ICP dispatch
               (COMPLETE_DISPATCH; "k200 dedup" itself runs with
               fused_align off, the JAX figures' MOLA_TPU_PALLAS=0): the
               K = 200 dedup map at the default (the fused align on the
               plain capture, B3 x2 an align), the generic loop over the
               per-voxel view (fused_align off, B4 only), capture_kernel
               off (B3 x2), phase1_neighbors 4 (B1, B2, B3 x2),
               refresh_reselect off (B1 x2, B3 x2) and fused_refresh off
               (B1, B3), each path's launches per align held exactly to
               DISPATCH_LAUNCHES (scans/s, device ops and launches a step,
               peak memory printed).  Each is held to the JAX package's CPU
               figures (K = 64, 200, the full-voxel and the dispatch paths
               as phases 7-8 are, C6's paths to the spreads alone;
               collision drops to its share; the final-pose GT error in
               float64 on both sides),
               its recorded kernel calls against their twins, its host
               syncs counted by call site.  Then the port's float64 oracle
               on the host beside the port's lidar3d-default at B=1: the
               three figures of tests/test_oracle_parity.py against the JAX
               engine's against the JAX oracle (ORACLE_FIGURES, with
               ORACLE_MARGIN) and the oracle's seconds per scan.  Last the
               fleet split (parallel/batch.py::ShardedFleet): B=8 over 4
               scans in two worker processes sharing the card (every
               visible card when there are more), equal to the one-process
               fleet bit for bit, both wall times printed.

 12. point axis — parallel/batch.py::PointShardedFleet, the JAX package's
               make_sharded_fleet_step: each scan's 131072 padded points
               split over the point cells of a mesh row, lidar3d-default
               (SIZING, B1-B3 on the whole ICP layer on every cell), then
               lidar3d-dual-map (DUALMAP_SIZING, the generic loop on B4, its
               normal equations all-reduced), then ROADMAP C14's paths:
               lidar3d-default without the per-voxel view (the generic
               loop on B4 at C = 160) and the K = 200 dedup map on the
               fused align over the plain capture, over POINT_SCANS bench
               scans.
               On one card a 1 x 2 mesh, both cells on the card over gloo
               (the split and the merge, not the scaling); with four or more
               cards nccl over fleet 2 x point 2 and then fleet 1 x point 4.
               Held against the one-process fleet of as many instances on
               the first card: lidar3d-default every output bit for bit,
               the others every integer output bit for bit and poses within
               POINT_POSE_TOL; every cell's map replica hashed and compared
               after every step.  Prints the collectives and their bytes per
               step of cell 0, the kernels launched in the cells (added to
               the kernels line) and the seconds per step beside the
               one-process fleet's.

 13. tools   — the port's measuring tools (apps/), over the first 16 scans
               of the bench's sequence (phases 4-12 take its first 8; the
               scans are simulated once, one process per CPU core):
               (a) apps/trace_step.py on the bench configuration
               (lidar3d-default, B=8, sized by apps/bench_sequence.py): 10
               warm-up steps, 6 under torch.profiler with Python stacks; the
               device ms per step, the top rows with the port's source
               that launched them, the busy share of the profiled window
               beside an unprofiled step, the five largest gaps of each
               device line and what follows them; B1-B3 must be among the
               aggregated device events.  (b) apps/profile_stages.py at
               B=1 and B=8 (the JAX script's sizes: raw 131072, ICP 8192,
               map 65536, 131072 slots, 20 repeats): each stage's ms and
               the kernels its calls launched.  (c) apps/cross_pipeline.py
               over the eight 3D pipelines and the first 12 scans at the
               JAX script's CAPS (B=1): each pipeline's worst gauge-aligned
               error within CROSS_BAND (0.03, docs/benchmarks.md's band) of
               CROSS_PIPELINE_JAX, the JAX package on a CPU driven as its
               script drives it, running the port's algorithm (the
               per-voxel capture: its TPU algorithm), and each frame's
               error in float64 within CROSS_FRAME_TOL (or
               CROSS_FRAME_TOL_APART) of the same figure from the JAX
               poses; printed beside the script at its CPU
               defaults (CROSS_PIPELINE_JAX_XLA) and docs/benchmarks.md's
               figures.  Then each pipeline again with per_voxel_nn off,
               held the same way to CROSS_PIPELINE_JAX_XLA, the JAX
               package's CPU algorithm.  (d) the multi-LiDAR grouping of
               utils/runtime.py::AsyncLidarOdometry: lidar3d-default with
               MOLA_LIDAR_COUNT=2, each of the 8 scans
               split by azimuth half into two labelled sensors stamped 5 ms
               apart: every group formed, every frame accepted, mean quality
               and final-pose GT error within QUALITY_SPREAD / GT_SPREAD of
               the same grouping on a CPU through the port
               (MULTI_LIDAR_CPU) and through the JAX package
               (MULTI_LIDAR_JAX).  The
               launches of phase 13 go into the kernels line.

Then one JSON line describing every kernel (launches summed over phases
4-13), the card's name and power limit, and last the JSON result line.  Any
failure raises and exits non-zero.  It imports nothing of JAX and nothing of
the JAX package.
"""

from __future__ import annotations

import collections
import contextlib
import io
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
    # phase 11: lidar3d-default at the configurations of COMPLETE, one
    # instance at the sizes the JAX package derives (COMPLETE_SIZING)
    # (JAX_PLATFORMS=cpu PYTHONPATH=. python tests/phase11_jax_figures.py)
    "k64": dict(iterations=[0, 6, 7, 23, 23, 23, 25, 24], final_pose_gt_error=0.1775668774069904,
                  quality=[1.0, 0.9995210766792297, 0.9985584020614624, 0.9947693943977356, 0.991391658782959, 0.9720616340637207, 0.9957305788993835, 0.9857482314109802]),
    "k200 dedup": dict(iterations=[0, 5, 4, 5, 13, 34, 8, 24], final_pose_gt_error=0.15126318117434384,
                  quality=[1.0, 0.9995210766792297, 0.9985584020614624, 0.9947693943977356, 0.991391658782959, 0.9720616340637207, 0.9957305788993835, 0.9852731823921204]),
    "no motion model": dict(iterations=[0, 8, 9, 5, 12, 24, 45, 38], final_pose_gt_error=0.020691194571786097,
                  quality=[1.0, 1.0, 0.9980778694152832, 0.9952448606491089, 0.991391658782959, 0.9749518036842346, 0.9677419066429138, 0.9824228286743164]),
    "anderson": dict(iterations=[0, 8, 7, 23, 7, 27, 5, 26], final_pose_gt_error=0.1994452292181606,
                  quality=[1.0, 1.0, 0.9990389347076416, 0.9952448606491089, 0.9923481345176697, 0.9735067486763, 0.9971536993980408, 0.9862232804298401]),
    "one-to-one": dict(iterations=[0, 7, 6, 24, 6, 34, 10, 23], final_pose_gt_error=0.20787465717845793,
                  quality=[1.0, 0.9022988677024841, 0.9481018781661987, 0.9343794584274292, 0.9301769733428955, 0.8901734352111816, 0.919829249382019, 0.924465537071228]),
    # the full-voxel tags at the JAX package's CPU defaults (MOLA_TPU_PALLAS=0 MOLA_TPU_PER_VOXEL_NN=0;
    # the same command, 4.4 min for the two on 8 cores)
    "full voxel": dict(iterations=[0, 5, 5, 23, 25, 27, 25, 23], final_pose_gt_error=0.1801386427258114,
                  quality=[1.0, 1.0, 0.9990389347076416, 0.9952448606491089, 0.9923481345176697, 0.97398841381073, 0.9971536993980408, 0.9862232804298401]),
    "full voxel dual-map": dict(iterations=[0, 5, 7, 6, 8, 15, 12, 14], final_pose_gt_error=0.17705749472656623,
                  quality=[1.0, 0.9995725154876709, 0.9994295239448547, 0.9964488744735718, 0.9944633841514587, 0.9827266335487366, 0.9971643090248108, 0.9905969500541687]),
    # the rest of the ICP dispatch, each tag under its environment in tests/phase11_jax_figures.py::ENVS
    # (the same command; about 7 min for the six, three at a time on 8 cores)
    "k200 dedup fused": dict(iterations=[0, 22, 6, 7, 10, 29, 23, 28], final_pose_gt_error=0.1496655291434215,
                  quality=[1.0, 0.9971264600753784, 0.9956751465797424, 0.991916298866272, 0.985659658908844, 0.9648362398147583, 0.9919354915618896, 0.9833729267120361]),
    "per-voxel generic": dict(iterations=[0, 5, 5, 23, 23, 27, 8, 28], final_pose_gt_error=0.1994279595948954,
                  quality=[1.0, 1.0, 0.9990389347076416, 0.9952448606491089, 0.9923481345176697, 0.97398841381073, 0.9971536993980408, 0.9862232804298401]),
    "capture off": dict(iterations=[0, 23, 8, 24, 22, 24, 13, 24], final_pose_gt_error=0.18874666693880196,
                  quality=[1.0, 0.9985632300376892, 0.99711674451828, 0.9938183426856995, 0.9875657558441162, 0.9672446846961975, 0.9947817921638489, 0.9833729267120361]),
    "phase1 4-probe": dict(iterations=[0, 5, 6, 23, 22, 24, 24, 25], final_pose_gt_error=0.2008257338825669,
                  quality=[1.0, 0.9985632300376892, 0.997597336769104, 0.9938183426856995, 0.9870874881744385, 0.9686897993087769, 0.9933586120605469, 0.9843230247497559]),
    "fresh refresh": dict(iterations=[0, 23, 8, 24, 22, 24, 13, 24], final_pose_gt_error=0.18874666693880196,
                  quality=[1.0, 0.9985632300376892, 0.99711674451828, 0.9938183426856995, 0.9875657558441162, 0.9672446846961975, 0.9947817921638489, 0.9833729267120361]),
    "single phase": dict(iterations=[0, 5, 5, 8, 5, 8, 8, 8], final_pose_gt_error=0.21945490764935138,
                  quality=[1.0, 1.0, 0.9990389347076416, 0.9952448606491089, 0.9923481345176697, 0.9735067486763, 0.9971536993980408, 0.9862232804298401]),
}
COMPLETE_FULL_VOXEL = ("full voxel", "full voxel dual-map")  # the JAX package's MOLA_TPU_PER_VOXEL_NN=0
# The rest of the JAX package's ICP dispatch: the fused align on the plain
# capture at 200 points per voxel (its refresh a fresh 4-probe capture),
# the generic loop over the per-voxel view, and the fused path's switches.
COMPLETE_DISPATCH = ("k200 dedup fused", "per-voxel generic", "capture off", "phase1 4-probe", "fresh refresh",
                     "single phase")
COMPLETE = ("k64", "k200 dedup", "no motion model", "anderson", "one-to-one") + COMPLETE_FULL_VOXEL + COMPLETE_DISPATCH
# Each tag's spec_from_yaml ICP overrides (tests/phase11_jax_figures.py
# gives the JAX package the matching MOLA_TPU_* environment).  "k200 dedup"
# is pinned to the generic loop: the JAX figures it is held to are its
# MOLA_TPU_PALLAS=0 run, and "k200 dedup fused" runs the default.
COMPLETE_KNOBS = {
    "k200 dedup": dict(fused_align=False), "anderson": dict(anderson_m=3),
    "full voxel": dict(per_voxel_nn=False), "full voxel dual-map": dict(per_voxel_nn=False),
    "per-voxel generic": dict(fused_align=False), "capture off": dict(capture_kernel=False),
    "phase1 4-probe": dict(phase1_neighbors=4), "fresh refresh": dict(refresh_reselect=False),
    "single phase": dict(fused_refresh=False),
}
# Every configuration of COMPLETE sizes as lidar3d-default does: the JAX
# package's utils/capacity.py derives SIZING for each (the command above
# prints them), and phase 11 holds the port's derivation to it.
COMPLETE_SIZING = dict({tag: SIZING for tag in ("k64", "k200 dedup", "no motion model", "anderson", "one-to-one",
                                                 "full voxel") + COMPLETE_DISPATCH}, **{"full voxel dual-map": DUALMAP_SIZING})
# Their collision drops against the points offered to the map over the 8
# scans (the same command): a 128- or 256-lane window makes each bucket a
# single way, so at the derived 65536 slots the deep maps drop ~1.1-1.2% of
# their points in both packages.  Phase 11 holds a path that drops to its
# share plus DROP_SPREAD, and a path that drops nothing in the JAX package
# to the other paths' 0.1%.
COMPLETE_DROPS = {"k64": (868, 73897), "k200 dedup": (832, 73899), "no motion model": (0, 73893),
                  "anderson": (0, 73899), "one-to-one": (0, 73898), "full voxel": (0, 73899),
                  "full voxel dual-map": (0, 74089), "k200 dedup fused": (831, 73897), "per-voxel generic": (0, 73899),
                  "capture off": (0, 73900), "phase1 4-probe": (0, 73899), "fresh refresh": (0, 73900),
                  "single phase": (0, 73897)}
DROP_SPREAD = 0.002
# Phase 11 (c): the JAX package's LidarOdometry (auto-sized, the TPU
# algorithm) beside its float64 oracle over the 8 bench scans, the three
# figures of tests/test_oracle_parity.py (the same command, tag "oracle";
# the oracle took 0.39-1.32 s a scan on the CPU it ran on).
ORACLE_FIGURES = dict(
    worst_pose_log_norm=0.02965892840738314, ate_share_of_path=0.03054375007026678,
    oracle_gt_error=[0.0, 0.0030324107319452624, 0.015796588889512155, 0.05022358184897915, 0.11041813286628593, 0.16436470475297854, 0.17539266116058985, 0.20147581275230272],
)
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


# Phase 11: lidar3d-default at the configurations that ran on the card for
# the first time in it, each at the sizes the port derives from the first
# scan (equal to the JAX package's, checked): 64 points per voxel (a
# 128-lane window on the fused path, B1-B3), 200 points per voxel with
# min_distance_between_points 0.2 (a 256-lane window with the dedup, the
# generic loop on B4 with fused_align off), and ROADMAP C6's paths, all on
# the generic loop: the no-motion-model ICP block (Horn, then Gauss-Newton)
# for every frame, Anderson acceleration of depth 3, and a one-to-one
# matcher.  Then the full-voxel capture (the JAX package's algorithm on
# every backend but a TPU: per_voxel_nn off, every point of each probed
# voxel, the generic loop on B4) on lidar3d-default (8 probes, C = 160) and
# on lidar3d-dual-map (27 probes, C = 540 and 270).  Last the rest of the
# dispatch (COMPLETE_DISPATCH): the K = 200 dedup map at the default (the
# fused align on the plain capture, B3 alone), the generic loop over the
# per-voxel view, and each of the fused path's switches.
def complete_cfg(tag: str, tmp: str, load_yaml_file) -> dict:
    """Phase 11's configuration ``tag`` as a loaded YAML tree, read with
    ``load_yaml_file`` (either package's): a copy of the pipeline written
    into ``tmp`` where a key changes (the repo's pipelines stay as they
    are), the environment where the pipeline reads one, and the ICP block
    edited in the tree for ROADMAP C6's paths.  The full-voxel tags load
    their pipeline as it is (the knob is not in the YAML)."""
    default = os.path.join(HERE, "pipelines", "lidar3d-default.yaml")
    if tag == "full voxel dual-map":
        return load_yaml_file(os.path.join(HERE, "pipelines", DUALMAP_PIPE), env={})
    if tag == "k64":
        return load_yaml_file(default, env={"MOLA_LOCALMAP_MAX_POINTS_PER_VOXEL": "64"})
    if tag in ("k200 dedup", "k200 dedup fused"):
        with open(default) as f:
            text = f.read()
        for old, new in (("${MOLA_LOCALMAP_MAX_POINTS_PER_VOXEL|20}", "200"),
                         ("min_distance_between_points: 0\n", "min_distance_between_points: 0.2\n")):
            if text.count(old) != 1:
                raise AssertionError(f"complete_cfg: {old!r} is not once in lidar3d-default.yaml")
            text = text.replace(old, new)
        path = os.path.join(tmp, "lidar3d-default-k200-dedup.yaml")
        with open(path, "w") as f:
            f.write(text)
        return load_yaml_file(path, env={})
    cfg = load_yaml_file(default, env={})
    if tag == "no motion model":
        cfg["icp_settings_with_vel"] = load_yaml_file(
            os.path.join(HERE, "pipelines", "extras", "icp-pipeline_no_motion_model.yaml"), env={})
    elif tag == "one-to-one":
        cfg["icp_settings_with_vel"]["matchers"][0]["params"]["allowMatchAlreadyMatchedGlobalPoints"] = False
    elif tag not in ("anderson", "full voxel") + COMPLETE_DISPATCH:
        raise ValueError(tag)
    return cfg


def oracle_figures(traj, engine, oracle, relative, se3_log) -> dict:
    """The three figures of tests/test_oracle_parity.py (:71-101) for an
    engine's poses against an oracle's, ``(R, t)`` pairs per frame, with
    that package's float64 ``relative`` and ``se3_log``: the worst per-pose
    SE(3) log-norm between them, the engine-to-oracle ATE-RMSE as a share
    of the path, and the oracle's gauge-aligned GT error at each frame."""
    worst = max(float(np.linalg.norm(se3_log(*relative(np.asarray(Ro, np.float64), np.asarray(to, np.float64),
                                                      np.asarray(Re, np.float64), np.asarray(te, np.float64)))))
                for (Re, te), (Ro, to) in zip(engine, oracle))
    d = np.stack([np.asarray(t, np.float64) for _, t in engine]) - np.stack([t for _, t in oracle])
    ate = float(np.sqrt(np.mean(np.sum(d ** 2, axis=1))))
    path = float(np.sum(np.linalg.norm(np.diff(traj.t[:len(engine)], axis=0), axis=1)))
    R0, t0 = traj.R[0], traj.t[0]
    gt = [float(np.linalg.norm(se3_log(*relative(R0.T @ traj.R[k], R0.T @ (traj.t[k] - t0), Ro, to))))
          for k, (Ro, to) in enumerate(oracle)]
    return dict(worst_pose_log_norm=worst, ate_rmse_m=ate, path_m=path, ate_share_of_path=ate / path,
                oracle_gt_error=gt)


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


def spread_guards(tag: str) -> dict:
    """Guards of a path held to the JAX package's CPU figures alone (phase
    11's ROADMAP C6 paths): the mean quality (scans 1 on) within
    QUALITY_SPREAD and the final-pose GT error within GT_SPREAD of the JAX
    package's over the same scans and sizes, without the bench's 0.9 /
    0.20."""
    ref = JAX_FIGURES[tag]
    q, gt = float(np.mean(ref["quality"][1:])), ref["final_pose_gt_error"]
    return dict(ref_quality=q, min_mean_quality=q - QUALITY_SPREAD, ref_gt_error=gt, max_gt_error=gt + GT_SPREAD)


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


def kernel_inputs(dev, seed=0, n_query=3072, slots=1 << 16, K=20, fill=0):
    """A bench-sized fleet map (``slots`` slots, ``K`` points per voxel)
    filled by the port's insert, and per-instance ICP points near the mapped
    surfaces.  With ``fill`` the last frame's points are inserted ``fill``
    times more, each time moved by up to 5 cm, without a budget: the voxels
    the ICP points probe then hold up to K points."""
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
    last = torch.from_numpy(surf[-1]).to(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    for _ in range(fill):
        moved = last + 0.05 * (2 * torch.rand(last.shape, generator=gen, device=dev) - 1)
        m, _ = vh.insert_stats(m, PointCloud.from_xyz(moved))
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


def align_setup(dev, B):
    """The poses, prior and tables of phase 3's aligns: returns the record
    ``c`` (entry, info, budget, maxit, gn_inner) and ``(entry, prior, info,
    thr, kc, budget, statics, zero)``."""
    import torch

    from mola_lidar_odometry_tpu_torch.ops import se3

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
    c = dict(entry=entry, info=info, budget=budget, maxit=maxit, gn_inner=statics["gn_inner"])
    return c, (entry, prior, info, thr, kc, budget, statics, zero)


def align_case(dev, m, local, valid):
    """The four kernel calls of one main-path align
    (``ops/icp.py::_align_fused_call``) at phase 3's inputs: B1 at an entry
    pose off the answer, B3 phase 1 from iteration 0, B2 at the settled pose,
    B3 phase 2 resuming the iteration count.  Each call's inputs come from
    the plain twins' outputs; returns the arguments and those outputs."""
    import torch

    from mola_lidar_odometry_tpu_torch.ops import pallas_capture as pc, pallas_icp as pi, se3
    from mola_lidar_odometry_tpu_torch.ops.icp import _FUSED_REFRESH_AT

    P = 8
    c, (entry, prior, info, thr, kc, budget, statics, zero) = align_setup(dev, valid.shape[0])
    c["P"] = P
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


WINDOW_KS = (30, 64, 126)  # beside phase 3's K = 20: a full 32-lane window, a 128-lane one, a full one


def capture_bounds(m, q0, valid, P, sectors, words):
    """B1's and B2's bounds at these inputs (``P`` probes over the 3072
    queries ``q0``): bytes of the distinct rows B1 probes read once, the
    rows it writes, the queries and the planes, B2 the ``sectors`` its
    selection needs (``pallas_capture.reselect_sectors``); operations, ~20
    a live point word dequantized and ranked (``words``) plus the picks."""
    import torch

    from mola_lidar_odometry_tpu_torch.ops.filters import voxel_coords, voxel_hash
    from mola_lidar_odometry_tpu_torch.ops.voxel_hash import neighbor_coords

    B, N = valid.shape
    npad, dev = 3072, q0.device
    vs = m.voxel_size.view(B, 1, 1)
    qp = torch.nn.functional.pad(q0, (0, 0, 0, npad - N))
    NB = m.data.shape[1]
    buckets = voxel_hash(neighbor_coords(qp, voxel_coords(qp, vs), vs, P), NB)
    vm = torch.nn.functional.pad(valid, (0, npad - N))
    spread = (torch.arange(npad, device=dev)[:, None] * P + torch.arange(P, device=dev)) % NB
    rows_read = torch.where(vm[..., None], buckets.long(), spread)
    uniq_rows = int(torch.unique(rows_read + torch.arange(B, device=dev).view(B, 1, 1) * NB).numel())
    q_bytes, planes, rows = B * N * 3 * 4 + B * N, 4 * B * 2 * P * npad * 4, B * P * npad * 512
    flops = (words + 2 * B * P * npad) * 20
    return bound(uniq_rows * 512 + q_bytes + planes + rows, flops), bound(sectors * 32 + 2 * q_bytes + planes, flops)


def capture_case(dev, m, local, valid, P, label, recs=None):
    """B1 and B2 against their twins on the card, bit for bit, at ``P``
    probes over map ``m``: B1 captures at an entry pose off the answer, B2
    reselects at the answer from B1's rows (the settled pose of an align).
    Each time is printed beside its bound (``capture_bounds``).  Raises the
    records' ``max_abs_err`` in ``recs``; returns how many probes found a
    way holding more than 32 points."""
    import torch

    from mola_lidar_odometry_tpu_torch.ops import pallas_capture as pc, se3

    B, N = valid.shape
    npad = 3072
    xi = torch.tensor([[0.06 + 0.01 * b, -0.04, 0.02, 0.002, -0.003, 0.006] for b in range(B)], device=dev)
    q0 = se3.transform(se3.se3_exp(xi), local).contiguous()
    args1, kw1 = (m.data, m.voxel_size, m.epoch, q0, P), dict(K=m.K, stride=m.stride, valid=valid, return_rows=True)
    ref1 = pc.capture_planar_plain(*args1, **kw1)
    got1 = pc.capture_planar(*args1, **kw1)
    args2, kw2 = (ref1[4], m.voxel_size, m.epoch, local.contiguous(), q0, P), dict(K=m.K, stride=m.stride,
                                                                                   valid=valid)
    ref2 = pc.capture_planar_reselect_plain(*args2, **kw2)
    got2 = pc.capture_planar_reselect(*args2, **kw2)
    torch.cuda.synchronize()
    for name, got, ref in (("capture_planar", got1, ref1), ("capture_planar_reselect", got2, ref2)):
        for i, (g, r) in enumerate(zip(got, ref)):
            if not torch.equal(g, r):
                raise AssertionError(f"{name} at {label} output {i} differs from its plain twin in "
                                     f"{int((g != r).sum())} elements")
        for rec in recs or ():
            if rec["name"] == name:
                rec["max_abs_err"] = max(rec["max_abs_err"], max_err(got, ref))
    sectors, words = pc.reselect_sectors(ref1[4], m.voxel_size, m.epoch, q0, P, m.K, m.stride)
    sel = ref1[4].view(B, P, npad, 128 // m.stride, m.stride)[..., 1] & 0xFFFF  # each way's count
    deep = int((sel > 32).any(dim=-1).sum())
    ms1 = cuda_graph_ms(pc.capture_launcher(*args1, **kw1)[0], 20)
    ms2 = cuda_graph_ms(pc.reselect_launcher(*args2, **kw2)[0], 20)
    pms1 = cuda_ms(lambda: pc.capture_planar_plain(*args1, **kw1), 2)
    pms2 = cuda_ms(lambda: pc.capture_planar_reselect_plain(*args2, **kw2), 2)
    b1, b2 = capture_bounds(m, q0, valid, P, sectors, words)
    paired = float(got1[3][:, :P].sum()) / float(valid.sum())
    log(f"kernels: {label}: B1 and B2 bit-exact vs plain on {B}x{P}x{npad} probes ({paired:.3f} probed voxels with "
        f"a candidate per valid query), {deep} of them on a way holding more than 32 points, {words} live point "
        f"words; B1 {ms1:.4f} ms (plain {pms1:.3f} ms, bound {b1[0]:.4f} ms by {b1[1]}), B2 {ms2:.4f} ms (plain "
        f"{pms2:.3f} ms, bound {b2[0]:.4f} ms by {b2[1]}, {sectors} sectors) on {torch.cuda.get_device_name(0)}")
    return deep


def phase_kernel_windows(dev):
    """B1 and B2 against their twins on the card (``capture_case``) at the
    windows past 32 points the fused path admits (``2 + K <= stride <=
    128``): K = 30 (stride 32, full), 64 and 126 (stride 128, the last
    full), 8 probes, on a ``kernel_inputs`` map filled until the probed
    voxels hold K points."""
    for K in WINDOW_KS:
        m, local, valid = kernel_inputs(dev, seed=K, K=K, fill=K + 2)
        deep = capture_case(dev, m, local, valid, 8, f"K={K} (stride {m.stride})")
        if K > 32 and deep == 0:
            raise AssertionError(f"K={K}: no probed way holds more than 32 points; the inputs miss the deep windows")


DISPATCH_K = 200  # a 256-lane slot: the fused align takes the plain capture
DISPATCH_PROBES = (4, 1)  # B1 and B2 at the probe counts of phase 11's phase1 4-probe and of a 1-probe run


def b3_bound(args, iters, gn_inner):
    """Kernel B3's bound for one launch on ``args`` (align_fused's
    positional arguments): each input read once and each output written
    once; ~9 operations a candidate and 18 + 45 a Gauss-Newton step per
    point, over the iterations these inputs ran (``iters``, each
    instance's, plus its quality pass)."""
    planes, pts = args[0], args[1]
    B, C, npad = planes[0].shape
    nbytes = B * pts.shape[1] * 13 + 4 * B * C * npad * 4 + 2 * args[8].numel() * 4 + B * 16 * 4
    return bound(nbytes, (int(iters.sum()) + B) * npad * (C * 9 + 18 + gn_inner * 45))


def phase_kernel_dispatch(dev, recs):
    """Phase 3's parts for the rest of the ICP dispatch (``ops/icp.py``),
    each kernel against its plain twin on the card, timed from CUDA-graph
    replays beside the twin and its bound:

    (a) kernel B3 on candidates from the plain per-voxel capture
        (``voxel_hash.capture``, handed to B3's wrapper as a ``CandSet``,
        transposed by ``pallas_icp.candset_planes``), the path of maps whose
        slot spans two rows: a K = 200 map (stride 256) filled until the
        probed voxels hold up to 200 points, lidar3d-default's 8 x 3072 ICP
        layer, phase 1 at 8 probes (C = 16) from phase 3's entry poses, then
        the refresh, a fresh 4-probe capture (C = 8) at phase 1's pose,
        resuming the iteration count; within ``B3_TOL`` with the same flags;
    (b) kernels B1 and B2 bit for bit at 4 and 1 probes (the 4-probe phase
        1 with its reselect, and a 1-probe footprint) on phase 3's K = 20
        map (``capture_case``).

    Raises the records' ``max_abs_err`` to the largest difference seen."""
    import torch

    from mola_lidar_odometry_tpu_torch.ops import pallas_icp as pi, se3, voxel_hash as vh
    from mola_lidar_odometry_tpu_torch.ops.icp import _FUSED_REFRESH_AT

    rec = {r["name"]: r for r in recs}
    card = torch.cuda.get_device_name(0)
    m, local, valid = kernel_inputs(dev, seed=DISPATCH_K, K=DISPATCH_K, fill=DISPATCH_K + 2)
    B, N = valid.shape
    if m.stride <= 128:
        raise AssertionError(f"K={DISPATCH_K}: stride {m.stride}; the plain capture's path needs a wider slot")
    c, (entry, prior, info, thr, kc, budget, statics, zero) = align_setup(dev, B)
    gn = c["gn_inner"]
    q0 = se3.transform(entry, local).contiguous()
    cs0 = vh.capture(m, q0, 8, per_voxel_nn=True)
    cap_ms = cuda_ms(lambda: pi.candset_planes(vh.capture(m, q0, 8, per_voxel_nn=True)), 3, 1)
    args_a = (cs0, local, valid, entry.R, entry.t, prior.R, prior.t, info, thr, kc,
              torch.clamp(budget, max=_FUSED_REFRESH_AT))
    kw_a = dict(it0=zero, **statics)
    ref_a = pi.align_fused_plain(*args_a, **kw_a)
    got_a = pi.align_fused(*args_a, **kw_a)
    torch.cuda.synchronize()
    err = check_align(f"B3 on the plain capture at K={DISPATCH_K}, C=16", got_a, ref_a)
    R1, t1, it1 = ref_a[:3]
    q1 = se3.transform(se3.Pose(R1, t1), local).contiguous()
    cs1 = vh.capture(m, q1, 4, per_voxel_nn=True)
    args_b = (cs1, local, valid, R1, t1, prior.R, prior.t, info, thr, kc, budget - it1)
    kw_b = dict(it0=it1, **statics)
    ref_b = pi.align_fused_plain(*args_b, **kw_b)
    got_b = pi.align_fused(*args_b, **kw_b)
    torch.cuda.synchronize()
    err = max(err, check_align(f"B3 on the plain capture at K={DISPATCH_K}, C=8", got_b, ref_b))
    rec["align_fused"]["max_abs_err"] = max(rec["align_fused"]["max_abs_err"], err)
    live = cs0.mask.sum(-1)
    deep = int((m.count() > 126).sum())
    log(f"kernels: B3 on the plain capture within tolerance of plain (max |dR|,|dt| {err:.3e}): K={DISPATCH_K} "
        f"(stride {m.stride}, {deep} voxels past 126 points), {B}x{N} points, phase 1 C=16 iterations "
        f"{ref_a[2].tolist()} hook {ref_a[3].tolist()}, the fresh 4-probe refresh C=8 iterations {ref_b[2].tolist()}; "
        f"live candidates per query mean {float(live.float().mean()):.2f}")
    if deep == 0 or not bool(ref_a[3][B - 2:].all()) or int(ref_b[2][: B - 2].min()) <= 0:
        raise AssertionError("B3 on the plain capture: the inputs need deep voxels, the far entries hooked and a "
                             "second phase that iterates")
    for label, args, kw, ref in (("C=16 (phase 1)", args_a, kw_a, ref_a), ("C=8 (the 4-probe refresh)", args_b, kw_b,
                                                                           ref_b)):
        planes = pi.candset_planes(args[0])
        launch = pi.align_launcher(pi.align_geometry(planes[0].shape[2], planes[0].shape[1]), planes, *args[1:],
                                   **kw)[0]
        ms = cuda_graph_ms(launch, 10)
        pms = cuda_ms(lambda: pi.align_fused_plain(*args, **kw), 1, 0)
        bd = b3_bound((planes,) + args[1:], ref[2], gn)
        log(f"kernels: B3 on the plain capture {label}: {ms:.4f} ms (plain {pms:.3f} ms, bound {bd[0]:.4f} ms by "
            f"{bd[1]}), {max(1, int(ref[2].max()))} iterations of the slowest instance, on {card}")
    log(f"kernels: the plain per-voxel capture at K={DISPATCH_K}, 8 probes, with the transpose into B3's planes "
        f"(no kernel; what the step runs in place of B1 at this depth): {cap_ms:.3f} ms on {card}")

    m, local, valid = kernel_inputs(dev)
    for P in DISPATCH_PROBES:
        capture_case(dev, m, local, valid, P, f"K={m.K}, P={P}", recs)


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


FULL_VOXEL_FILL = 20  # extra inserts of the last frame, so the probed voxels hold up to K points


def phase_kernel_match_full_voxel(dev, rec=None):
    """Kernel B4 against its plain twin on the card, bit for bit, at the
    full-voxel widths (``per_voxel_nn`` off: every point of each probed
    voxel is a candidate, ``C = P*K``): lidar3d-default's 3072-point ICP
    layer at 8 probes of a K = 20 map (C = 160), and lidar3d-dual-map's two
    layers at 27 probes (K = 20 and 10: C = 540 over 3072 points, 270 over
    6656), on ``kernel_inputs`` maps filled until the probed voxels hold up
    to K points.  Each shape selects at an entry pose off the answer and at
    the answer, and is timed as phase 3 times B4 (CUDA-graph replays),
    beside its plain twin's time and its bound.  Raises ``rec``'s
    ``max_abs_err`` to the largest difference seen."""
    import torch

    from mola_lidar_odometry_tpu_torch.ops import pallas_match as pm, se3, voxel_hash as vh

    caps = DUALMAP_SIZING["layer_capacities"]
    card = torch.cuda.get_device_name(0)
    shapes = [  # (label, map K, N, probes)
        ("lidar3d-default: decimated_for_icp -> localmap", 20, SIZING["layer_capacities"]["decimated_for_icp"], 8),
        ("dual-map: decimated_for_icp -> localmap", 20, caps["decimated_for_icp"], 27),
        ("dual-map: decimated_for_icp_near -> localmap_far", 10, caps["decimated_for_icp_near"], 27),
    ]
    for label, K, N, P in shapes:
        m, local, _ = kernel_inputs(dev, seed=K + P, n_query=N, slots=DUALMAP_SIZING["map_slots"], K=K,
                                    fill=FULL_VOXEL_FILL)
        local = local.clone()
        local[:, ::31, 2] += 30.0  # points far above the map: no candidate at all
        xi = torch.tensor([[0.06 + 0.01 * b, -0.04, 0.02, 0.002, -0.003, 0.006] for b in range(BATCH)], device=dev)
        q_entry = se3.transform(se3.se3_exp(xi), local).contiguous()
        planar = pm.to_planar(vh.capture(m, q_entry, P, per_voxel_nn=False))
        C = planar.mask.shape[-1]
        if C != P * K or planar.x.shape != (BATCH, N, C):
            raise AssertionError(f"B4 full voxel {label}: planes {tuple(planar.x.shape)}, expected {(BATCH, N, P * K)}")
        err, n_none = 0.0, 0
        for queries in (q_entry, local.contiguous()):
            got, ref = pm.nn_select(planar, queries), pm.nn_select_plain(planar, queries)
            torch.cuda.synchronize()
            for g, r, name in zip(got, ref, ("target", "d2min")):
                if not torch.equal(g + 0.0, r + 0.0):
                    raise AssertionError(f"B4 full voxel {label}: {name} differs from its plain twin in "
                                         f"{int((g != r).sum())} elements")
            n_none += int((got[1] > 1e37).sum())
            err = max(err, max_err(got, ref))
        live = planar.mask.sum(-1)
        if n_none == 0 or int(live.max()) <= 2 * P:
            raise AssertionError(f"B4 full voxel {label}: the inputs need queries with no candidate and rows with "
                                 f"more candidates than the per-voxel view keeps ({int(live.max())})")
        ms = cuda_graph_ms(lambda: pm.nn_select(planar, q_entry), 20)
        pms = cuda_ms(lambda: pm.nn_select_plain(planar, q_entry), 5, 1)
        bd = bound(BATCH * N * (16 * C + 12 + 16), BATCH * N * C * 9)
        if rec is not None:
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
        log(f"kernels: B4 full voxel bit-exact vs plain on {BATCH}x{N}x{C} ({label}, {P} probes x K={K}; "
            f"max |d| {err}); {n_none} selects found no candidate; live candidates per query mean "
            f"{float(live.float().mean()):.1f}, max {int(live.max())}; {ms:.4f} ms (plain {pms:.3f} ms, bound "
            f"{bd[0]:.4f} ms by {bd[1]}, {100 * bd[0] / ms:.1f}% of it) on {card}")


# ---------------------------------------------------------------------------
# phases 4 and 5: the two paths — the B=8 fleet over the bench's scans
# ---------------------------------------------------------------------------


LAST_PROFILE = {}  # the figures of the last profiled step


def profile_step(fstep, carry, scan):
    """One fleet step under torch.profiler: wall time, device-busy time and
    the device kernels that take the most of it (apps/trace_step.py's
    aggregation of the trace's device events by name)."""
    from mola_lidar_odometry_tpu_torch.apps.trace_step import profile_device

    (carry, out), wall, rows, total = profile_device(lambda: fstep(carry, scan), "cuda")
    rows = [r for r in rows if r[1] > 0]
    busy = total / 1e3
    n_kernels = sum(r[2] for r in rows)
    log(f"profile: last step {wall:.2f} ms wall (profiled), device busy {busy:.3f} ms "
        f"({100 * busy / wall:.1f}%), {n_kernels} device kernels/copies")
    LAST_PROFILE.update(wall_ms=wall, busy_ms=busy, device_ops=n_kernels)
    own = ("capture_gather_kernel", "reselect_kernel", "align_kernel", "nn_select_kernel")  # wherever they rank
    for name, us, n in rows[:12] + [r for r in rows[12:] if any(k in r[0] for k in own)]:
        log(f"profile:   {us / 1e3:8.3f} ms  x{n:<5d} {name[:90]}")
    return carry, out


@contextlib.contextmanager
def call_count(mod, name):
    """While open, ``mod.name`` counts its calls in the one element of the
    list it yields."""
    fn, n = getattr(mod, name), [0]

    def call(*a, **k):
        n[0] += 1
        return fn(*a, **k)

    setattr(mod, name, call)
    try:
        yield n
    finally:
        setattr(mod, name, fn)


def run_fleet(dev, recs, tag, pipeline, sizing, scans, traj, guards, map_names, count_syncs=False, params=None,
              f64=False):
    """Step the B=8 fleet of ``pipeline`` (a path under pipelines/, or a
    loaded YAML tree) through ``scans`` on the kernels
    with every launch count set to 0 just before and read just after;
    returns (scans/s, launches of this path per kernel name, outputs, the
    last carry).
    With ``count_syncs`` the step before the profiled last one counts the
    host syncs torch flags (printed by call site) and records its kernel
    calls (and is left out of the rate); after the counts are read, each
    recorded call is held against its plain twin at this path's own shapes.
    ``params`` are set in the pipeline's ``params`` block; ``sizing`` may
    also hold spec_from_yaml's ICP overrides.  With ``f64`` the final-pose
    GT error is the float64 figure (``gt_error_f64``), else float32."""
    import torch

    from mola_lidar_odometry_tpu_torch.models import step as step_mod
    from mola_lidar_odometry_tpu_torch.models.spec import spec_from_yaml
    from mola_lidar_odometry_tpu_torch.ops import icp as icp_ops
    from mola_lidar_odometry_tpu_torch.parallel import batch as pb
    from mola_lidar_odometry_tpu_torch.utils.config import load_yaml_file

    n_scans = len(scans)
    cfg = pipeline if isinstance(pipeline, dict) else load_yaml_file(os.path.join(HERE, "pipelines", pipeline), env={})
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
    with call_count(icp_ops, "align") as aligns:
        for k in range(n_scans - 1):
            counted = count_syncs and k == n_scans - 2
            with flagged_syncs(counted) as hits, recording(recs, calls) if counted else contextlib.nullcontext():
                t1 = time.time()
                carry, out = fstep(carry, seq[k])
                torch.cuda.synchronize()
            if counted:
                syncs = len(hits)
                sites = collections.Counter(f"{os.path.relpath(w.filename, HERE)}:{w.lineno}" for w in hits)
            else:
                secs.append(time.time() - t1)
            outs.append(out)
        carry, out = profile_step(fstep, carry, seq[-1])  # the last frame, under the profiler
    outs.append(out)
    launches = {r["name"]: r["wrapper"].launches for r in recs}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # the recorded calls' inputs, cloned, stay on the card until they are checked
    held_gb = sum(t.numel() * t.element_size() for c in calls for t in _tensors(c[1:]) if t.is_cuda) / 1e9
    LAST_PROFILE.update(peak_gb=peak_gb, recorded_gb=held_gb, aligns=aligns[0])

    q = torch.stack([o.quality for o in outs]).cpu().numpy()
    accepted = torch.stack([o.accepted for o in outs]).cpu().numpy()
    nicp = torch.stack([o.n_icp_layer for o in outs]).cpu().numpy()
    nmap = torch.stack([o.n_map_layer for o in outs]).cpu().numpy()
    drops = int(torch.stack([o.map_collision_drops for o in outs]).sum())
    iters = torch.stack([o.iterations for o in outs]).cpu().numpy()
    corr = int(torch.stack([o.corrections for o in outs]).sum())
    gt_err = (gt_error_f64 if f64 else gt_error)(traj, n_scans - 1, carry.pose_R[0].cpu(), carry.pose_t[0].cpu())
    icp_cap = widths[spec.icp_local_layer]
    map_cap = widths[spec.map_inserts[0].input_layer]
    warm = 2  # frame 0 seeds the map, frame 1 is the first ICP on it
    sps = BATCH * len(secs[warm:]) / sum(secs[warm:])
    card = torch.cuda.get_device_name(0)
    log(f"{tag}: per-step seconds {[round(s, 4) for s in secs]}")
    log(f"{tag}: mean quality (frames > 0) {q[1:].mean():.4f}; iterations per frame {iters[:, 0].tolist()}; "
        f"twist corrections {corr}; final-pose GT error {gt_err:.4f}{' (float64)' if f64 else ''}; "
        f"icp layer max {int(nicp.max())}/{icp_cap}; "
        f"map layer max {int(nmap.max())}/{map_cap}; collision drops {drops}/{int(nmap.sum())} "
        f"over {len(map_names)} map(s)")
    log(f"{tag}: {sps:.2f} scans/s over frames {warm}..{len(secs) - 1} (B={BATCH}) on {card}; "
        f"peak device memory {peak_gb:.3f} GB"
        + (f" ({held_gb:.3f} GB of it the copies of step {n_scans - 2}'s recorded kernel calls)" if held_gb else ""))
    log(f"{tag}: launches " + ", ".join(f"{k}={v} ({v / n_scans:.2f}/step)" for k, v in launches.items()))
    if syncs is not None:
        log(f"{tag}: host syncs flagged by torch in step {n_scans - 2}: {syncs} (that step is left out of the rate); "
            "by call site: " + ", ".join(f"{k} x{v}" for k, v in sites.most_common()))
    failures = guard_failures(float(q[1:].mean()), gt_err, guards)
    if not accepted[1:].all():
        failures.append(f"frames not accepted: {np.argwhere(~accepted).tolist()}")
    if not nicp.max() < icp_cap:
        failures.append(f"{spec.icp_local_layer} saturated ({int(nicp.max())})")
    if not nmap.max() < map_cap:
        failures.append(f"{spec.map_inserts[0].input_layer} saturated ({int(nmap.max())})")
    share = guards.get("max_drop_share", 1e-3)
    if drops > share * nmap.sum():  # the drops of every map against one map's points: stricter than per map
        failures.append(f"collision drops {drops} > {100 * share:.2f}% of {int(nmap.sum())}")
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
    from mola_lidar_odometry_tpu_torch.apps.cross_pipeline import gt_error as error

    return error(traj, k, R, t)


def gt_error_f64(traj, k, R, t) -> float:
    """The same error in float64 (ROADMAP C16: the float32 figure moves by
    up to ~0.03 near 1-3 mrad), as tests/phase11_jax_figures.py computes
    the JAX figures phase 11 holds."""
    from mola_lidar_odometry_tpu_torch.apps.cross_pipeline import gt_error_f64 as error

    return error(traj, k, R, t)


class _Recorder:
    """Stands in for a kernel's wrapper in its module: appends (record,
    args, kwargs), its tensors cloned, to ``calls`` and calls the wrapper.
    ``launches`` is the wrapper's own count (a wrapper counts through its
    module-level name, which now names this object)."""

    def __init__(self, wrapper, rec, calls):
        self._w, self._r, self._calls = wrapper, rec, calls

    def __call__(self, *a, **k):
        from mola_lidar_odometry_tpu_torch.utils.tree import clone

        self._calls.append((self._r, clone(a), clone(k)))
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


# ---------------------------------------------------------------------------
# phase 11: complete — the windows past 32 points and the dedup on the main
# paths, ROADMAP C6's paths, the float64 oracle, the fleet split
# ---------------------------------------------------------------------------

# Each fused-dispatch path's launches of every kernel per align (a step
# that re-enters for a twist correction aligns again); "per-voxel generic"
# runs the generic loop, B4 a launch an iteration.
DISPATCH_LAUNCHES = {
    "k200 dedup fused": dict(capture_planar=0, capture_planar_reselect=0, align_fused=2, nn_select=0),
    "per-voxel generic": dict(capture_planar=0, capture_planar_reselect=0, align_fused=0),
    "capture off": dict(capture_planar=0, capture_planar_reselect=0, align_fused=2, nn_select=0),
    "phase1 4-probe": dict(capture_planar=1, capture_planar_reselect=1, align_fused=2, nn_select=0),
    "fresh refresh": dict(capture_planar=2, capture_planar_reselect=0, align_fused=2, nn_select=0),
    "single phase": dict(capture_planar=1, capture_planar_reselect=0, align_fused=1, nn_select=0),
}
# the kernels each path must launch (the others run the generic loop on B4)
COMPLETE_KERNELS = dict({"k64": MAIN_KERNELS}, **{tag: tuple(k for k, n in per.items() if n) or DUALMAP_KERNELS
                                                  for tag, per in DISPATCH_LAUNCHES.items()})
# How far phase 11 (c)'s figures may read from ORACLE_FIGURES: the port's
# engine on the card parts from the JAX package's on the CPU by a few
# millimetres over these scans (phase 4's GT error 0.1847 against 0.1849),
# so 0.01 on a log-norm and 0.5% of the 0.63 m path (3 mm) on the ATE; the
# two oracles are the same float64 arithmetic, so their GT errors agree to
# 1e-6.
ORACLE_MARGIN = dict(pose=0.01, ate_share=0.005, gt=1e-6)
FLEET_SPLIT_SCANS = 4
# Phase 11's paths held to the spreads of the JAX figures alone, without the
# bench's 0.9 / 0.20: C6's paths, whose own GT errors sit at 0.02-0.21.
SPREADS_ONLY = ("no motion model", "anderson", "one-to-one")


def phase_complete(dev, recs, scans, traj, tags=COMPLETE, rest=True):
    """Phase 11: (a)-(b) lidar3d-default at K = 64 and at K = 200 with the
    dedup, then ROADMAP C6's paths, each at B = 8 over the 8 bench scans at
    the sizes the port derives (equal to the JAX package's), held to the JAX
    package's CPU figures as phases 7-8 are, its recorded kernel calls held
    against their twins and its host syncs counted by call site; (c) the
    port's float64 oracle beside the port at B = 1; (d) the fleet split over
    two worker processes.  ``tags`` are the paths of (a)-(b) run, (c) and
    (d) run with ``rest``.  Returns each kernel's launches in this phase."""
    import tempfile

    from mola_lidar_odometry_tpu_torch.models.spec import spec_from_yaml
    from mola_lidar_odometry_tpu_torch.utils.capacity import derive_capacities
    from mola_lidar_odometry_tpu_torch.utils.config import load_yaml_file

    t_phase = time.time()
    launches = collections.Counter()
    x0, t0, _, v0 = scans[0]
    max_pts = max(int(v.sum()) for _, _, _, v in scans)
    for tag in tags:
        with tempfile.TemporaryDirectory() as tmp:
            cfg = complete_cfg(tag, tmp, load_yaml_file)
        names = ("raw_capacity", "map_slots", "layer_capacities", "insert_budgets")
        sizing = dict(zip(names, derive_capacities(spec_from_yaml(cfg), x0[v0], t0[v0], with_budgets=True,
                                                   known_max_points=max_pts)))
        if sizing != COMPLETE_SIZING[tag]:
            raise AssertionError(f"{tag}: the port derives {sizing}, the JAX package {COMPLETE_SIZING[tag]}")
        # the ICP knobs go through spec_from_yaml's overrides, as a user's call does
        knobs = COMPLETE_KNOBS.get(tag, {})
        drops, offered = COMPLETE_DROPS[tag]
        # (a), (b) and the other paths as phase 4 is guarded, and within the
        # spreads of the JAX figures; SPREADS_ONLY within the spreads alone
        guards = spread_guards(tag) if tag in SPREADS_ONLY else reference_guards(tag)
        guards["max_drop_share"] = max(1e-3, drops / offered + DROP_SPREAD) if drops else 1e-3
        kernels = COMPLETE_KERNELS.get(tag, DUALMAP_KERNELS)
        map_names = tuple(d.name for d in spec_from_yaml(cfg).map_layers)
        sps, here, _, carry = run_fleet(dev, recs, tag, cfg, dict(sizing, **knobs), scans, traj,
                                        dict(guards, kernels=kernels), map_names, count_syncs=True, f64=True)
        m = carry.maps["localmap"]
        spec = spec_from_yaml(cfg, **knobs)
        icp = spec.icp_with_vel
        log(f"{tag}: map K={m.K} stride {m.stride}, min_distance_between_points "
            f"{spec.map_layers[0].min_distance_between_points}; ICP: Horn "
            f"{icp.horn is not None}, Anderson depth {icp.anderson_m}, one-to-one "
            f"{not icp.matchers[0].allow_match_already_matched}, per_voxel_nn {icp.per_voxel_nn}, "
            f"{icp.nn_neighbors} probes; overrides {knobs}; sized {json.dumps(sizing)} (= the JAX package's)")
        print_reference(tag, guards)
        if tag in COMPLETE_FULL_VOXEL:
            full_voxel_summary(tag, spec, carry, sps, here)
        if tag in COMPLETE_DISPATCH:
            dispatch_summary(tag, sps, here)
        launches.update(here)
    if rest:
        launches.update(phase_oracle(dev, recs, scans, traj))
        phase_fleet_split(dev, scans, traj)
    log(f"complete: phase 11 took {time.time() - t_phase:.1f} s")
    return launches


def full_voxel_summary(tag, spec, carry, sps, launches):
    """A full-voxel path's figures (its candidate widths, scans/s, device ops
    and B4 launches a step, peak memory); B1-B3 must not have launched."""
    import torch

    widths = [f"{mc.global_layer} C={spec.icp_with_vel.nn_neighbors * carry.maps[mc.global_layer].K}"
              for mc in spec.icp_with_vel.matchers]
    log(f"{tag}: full voxel ({', '.join(widths)}): {sps:.2f} scans/s (B={BATCH}), {LAST_PROFILE['device_ops']} "
        f"device ops in the profiled last step, B4 {launches['nn_select'] / N_SCANS:.2f} launches a step, "
        f"max_memory_allocated {LAST_PROFILE['peak_gb']:.3f} GB over the steps, "
        f"{LAST_PROFILE['peak_gb'] - LAST_PROFILE['recorded_gb']:.3f} GB without the recorded calls' copies, "
        f"on {torch.cuda.get_device_name(0)}")
    fused = {k: launches[k] for k in MAIN_KERNELS if launches[k]}
    if fused:
        raise AssertionError(f"{tag}: the full-voxel path launched {fused}; it must run the generic loop alone")


def dispatch_summary(tag, sps, launches):
    """A fused-dispatch path's figures (scans/s, device ops and launches a
    step, launches per align, peak memory), its launches per align held to
    DISPATCH_LAUNCHES."""
    import torch

    aligns = LAST_PROFILE["aligns"]
    per = {k: v / max(aligns, 1) for k, v in launches.items()}
    log(f"{tag}: {sps:.2f} scans/s (B={BATCH}), {LAST_PROFILE['device_ops']} device ops in the profiled last step, "
        f"launches a step {({k: v / N_SCANS for k, v in launches.items()})}, {aligns} aligns over {N_SCANS} steps, "
        f"launches per align {per}, max_memory_allocated {LAST_PROFILE['peak_gb']:.3f} GB over the steps, "
        f"{LAST_PROFILE['peak_gb'] - LAST_PROFILE['recorded_gb']:.3f} GB without the recorded calls' copies, "
        f"on {torch.cuda.get_device_name(0)}")
    off = {k: per[k] for k, n in DISPATCH_LAUNCHES[tag].items() if launches[k] != n * aligns}
    if off or aligns < N_SCANS - 1:
        raise AssertionError(f"{tag}: launches per align {off} over {aligns} aligns, expected "
                             f"{DISPATCH_LAUNCHES[tag]}")


def phase_oracle(dev, recs, scans, traj):
    """Phase 11 (c): the port's float64 oracle on the host beside the port's
    lidar3d-default at B = 1 (``LidarOdometry``, auto-sized) over the 8
    bench scans; the three figures of tests/test_oracle_parity.py against
    the JAX engine's against the JAX oracle (ORACLE_FIGURES): the JAX file's
    bounds (0.1, 1% of the path, 0.25) where the JAX run meets them, else
    the JAX figure plus ORACLE_MARGIN; the port within ORACLE_MARGIN of the
    JAX figures (the two oracles are the same float64 arithmetic, so their
    GT errors agree to 1e-6)."""
    from mola_lidar_odometry_tpu_torch.models.spec import spec_from_yaml
    from mola_lidar_odometry_tpu_torch.oracle import OracleOdometry, relative, se3_log
    from mola_lidar_odometry_tpu_torch.utils.config import load_yaml_file

    for r in recs:
        r["wrapper"].launches = 0
    _, outs, secs, _, _ = run_host(dev, "oracle engine", "lidar3d-default.yaml", scans, traj, MAIN_GUARDS)
    here = {r["name"]: r["wrapper"].launches for r in recs}
    oracle = OracleOdometry(spec_from_yaml(load_yaml_file(os.path.join(HERE, "pipelines", "lidar3d-default.yaml"),
                                                          env={})))
    ora, osecs = [], []
    for k, (xyz, times, rings, valid) in enumerate(scans):
        t1 = time.time()
        o = oracle.step(xyz[valid].astype(np.float64), times[valid].astype(np.float64), float(traj.stamps[k]))
        osecs.append(time.time() - t1)
        ora.append(o)
    got = oracle_figures(traj, [(o.pose_R, o.pose_t) for o in outs], [(o.R, o.t) for o in ora], relative, se3_log)
    ref = ORACLE_FIGURES
    log(f"oracle: worst engine-to-oracle SE(3) log-norm {got['worst_pose_log_norm']:.4f} (JAX engine to JAX oracle "
        f"{ref['worst_pose_log_norm']:.4f}); engine-to-oracle ATE-RMSE {got['ate_rmse_m']:.4f} m = "
        f"{100 * got['ate_share_of_path']:.3f}% of the {got['path_m']:.2f} m path (JAX "
        f"{100 * ref['ate_share_of_path']:.3f}%); oracle GT error per frame "
        f"{[round(e, 4) for e in got['oracle_gt_error']]} (JAX oracle {[round(e, 4) for e in ref['oracle_gt_error']]}); "
        f"the port's GT error per frame {[round(gt_error(traj, k, o.pose_R, o.pose_t), 4) for k, o in enumerate(outs)]}")
    log(f"oracle: {np.mean(osecs):.3f} s per scan on the host ({[round(x, 2) for x in osecs]}), every frame "
        f"accepted {all(o.accepted for o in ora)}, oracle quality {[round(o.quality, 4) for o in ora]}")
    failures = []
    for key, bound_ in (("worst_pose_log_norm", 0.1), ("ate_share_of_path", 0.01)):
        lim = bound_ if ref[key] < bound_ else ref[key] + ORACLE_MARGIN["ate_share" if "ate" in key else "pose"]
        if not got[key] < lim:
            failures.append(f"{key} {got[key]:.5f} >= {lim:.5f}")
        if not abs(got[key] - ref[key]) <= ORACLE_MARGIN["ate_share" if "ate" in key else "pose"]:
            failures.append(f"{key} {got[key]:.5f} is more than the margin from the JAX package's {ref[key]:.5f}")
    worst_gt = max(ref["oracle_gt_error"])
    lim = 0.25 if worst_gt < 0.25 else worst_gt + ORACLE_MARGIN["pose"]
    if not max(got["oracle_gt_error"]) < lim:
        failures.append(f"oracle GT error {max(got['oracle_gt_error']):.4f} >= {lim:.4f}")
    gap = max(abs(a - b) for a, b in zip(got["oracle_gt_error"], ref["oracle_gt_error"]))
    if not gap <= ORACLE_MARGIN["gt"]:
        failures.append(f"the port's oracle GT errors differ from the JAX oracle's by {gap:.3g}")
    if not all(o.accepted for o in ora):
        failures.append("the oracle rejected a frame")
    if failures:
        raise AssertionError("oracle: " + "; ".join(failures))
    log(f"oracle: within the gates (0.1 / 1% / 0.25 where the JAX run meets them, else its figure plus "
        f"{ORACLE_MARGIN}); the two oracles' GT errors differ by {gap:.3g}")
    return here


def phase_fleet_split(dev, scans, traj):
    """Phase 11 (d): lidar3d-default at B = 8 over 4 bench scans, in one
    process and split over two worker processes (``ShardedFleet``) that
    share the card, or over every visible card when there are more: the
    poses, quality, flags and layer counts gathered back must equal the
    one-process fleet's bit for bit.  The kernels launched in the workers
    are counted there, not in this process's records."""
    import torch

    from mola_lidar_odometry_tpu_torch.models.spec import spec_from_yaml
    from mola_lidar_odometry_tpu_torch.parallel import batch as pb
    from mola_lidar_odometry_tpu_torch.utils.config import load_yaml_file

    n_cards = torch.cuda.device_count()
    devices = [f"cuda:{i}" for i in range(n_cards)] if n_cards > 1 else ["cuda:0", "cuda:0"]
    spec = spec_from_yaml(load_yaml_file(os.path.join(HERE, "pipelines", "lidar3d-default.yaml"), env={}),
                          kf_ring_capacity=256, **SIZING)
    sub = scans[:FLEET_SPLIT_SCANS]
    fstep = pb.make_fleet_step(spec)
    carry = pb.init_fleet_carry(spec, BATCH, device=dev)
    ref, one_s = [], []
    for k, s_ in enumerate(sub):
        t1 = time.time()
        carry, out = fstep(carry, pb.pack_scans(spec, [s_] * BATCH, [traj.stamps[k]] * BATCH, device=dev))
        ref.append(host_fields(out))
        one_s.append(time.time() - t1)
    t1 = time.time()
    with pb.ShardedFleet(spec, BATCH, devices) as fleet:
        start_s = time.time() - t1
        got, split_s = [], []
        for k, s_ in enumerate(sub):
            t1 = time.time()
            got.append(fleet.step([s_] * BATCH, [traj.stamps[k]] * BATCH))
            split_s.append(time.time() - t1)
    fields = ("pose_R", "pose_t", "quality", "iterations", "processed", "accepted", "kf_local", "kf_simplemap",
              "n_raw", "n_icp_layer", "n_map_layer", "corrections", "map_collision_drops")
    for k, (g, r) in enumerate(zip(got, ref)):
        for f in fields:
            if not np.array_equal(getattr(g, f), r[f]):
                raise AssertionError(f"fleet split: {f} at scan {k} differs from the one-process fleet's "
                                     f"({np.abs(getattr(g, f).astype(np.float64) - r[f]).max()})")
    log(f"fleet split: B={BATCH} over {len(devices)} worker processes on {sorted(set(devices))}, "
        f"{BATCH // len(devices)} instances each: poses, quality, flags and layer counts equal the one-process "
        f"fleet's bit for bit over {len(sub)} scans; wall {split_s[0]:.3f} s for the first step (fresh workers load "
        f"their kernels) and {sum(split_s[1:]):.3f} s for the other {len(sub) - 1} (workers started in "
        f"{start_s:.1f} s) against {one_s[0]:.3f} s and {sum(one_s[1:]):.3f} s in this process"
        + ("; with one card this checks the split and the merge, not the scaling" if n_cards <= 1 else ""))


# ---------------------------------------------------------------------------
# phase 12: the point axis
# ---------------------------------------------------------------------------

POINT_SCANS = 4
# dual-map's poses through the point axis against the one-process fleet's:
# the normal equations are summed per cell and then across the cells, in
# another order than one card sums them; the loop stops on steps below
# 1e-4 m and 5e-5 rad, so the reordering moves the answer by a small part
# of the last step, a tenth of which is the bound (tests/test_torch_point_axis.py)
POINT_POSE_TOL = 1e-5
POINT_ANSWER_S = 180.0  # a cell that does not answer a step in this time ends the phase
POINT_INTEGERS = ("iterations", "processed", "accepted", "kf_local", "kf_simplemap", "sm_insert", "map_restarted",
                  "n_raw", "n_icp_layer", "n_map_layer", "corrections", "map_collision_drops", "map_full_drops",
                  "deferred_drops")


def point_meshes():
    """The meshes phase 12 runs: a 1 x 2 mesh on one card (gloo), or nccl
    over distinct cards: 2 x 2 then 1 x 4 with four or more, 1 x 2 with
    two or three."""
    import torch

    from mola_lidar_odometry_tpu_torch.parallel import batch as pb

    n = torch.cuda.device_count()
    if n >= 4:
        return [pb.make_mesh(4, point_axis=2), pb.make_mesh(4, point_axis=4)]
    if n >= 2:
        return [pb.make_mesh(2, point_axis=2)]
    return [[["cuda:0", "cuda:0"]]]


POINT_PATHS = ("default", "dual-map", "full voxel", "k200 dedup fused")
POINT_EXACT = ("default",)  # bit for bit; the others' integers exact and poses within POINT_POSE_TOL


def point_path(tag: str, tmp: str):
    """Phase 12's path ``tag``: (the loaded YAML tree, its sizing, its ICP
    overrides).  "full voxel" is lidar3d-default without the per-voxel view
    (the generic loop on B4 at C = 160); "k200 dedup fused" phase 11's K =
    200 dedup map at the default (the fused align on the plain capture)."""
    from mola_lidar_odometry_tpu_torch.utils.config import load_yaml_file

    if tag == "dual-map":
        return load_yaml_file(os.path.join(HERE, "pipelines", DUALMAP_PIPE), env={}), DUALMAP_SIZING, {}
    if tag == "k200 dedup fused":
        return complete_cfg(tag, tmp, load_yaml_file), COMPLETE_SIZING[tag], {}
    cfg = load_yaml_file(os.path.join(HERE, "pipelines", "lidar3d-default.yaml"), env={})
    return cfg, SIZING, (COMPLETE_KNOBS[tag] if tag == "full voxel" else {})


def phase_point_axis(dev, scans, traj, tags=POINT_PATHS):
    """Phase 12: the paths ``tags`` (lidar3d-default, lidar3d-dual-map, and
    ROADMAP C14's: lidar3d-default without the per-voxel view, and the K =
    200 dedup map on the fused align over the plain capture) through the
    point axis on each of :func:`point_meshes` against the one-process fleet
    on the first card (see the module docstring).  Returns each kernel's
    launches in the cells."""
    import tempfile

    import torch

    from mola_lidar_odometry_tpu_torch.models.spec import spec_from_yaml
    from mola_lidar_odometry_tpu_torch.parallel import batch as pb

    t_phase = time.time()
    launches = collections.Counter()
    sub = scans[:POINT_SCANS]
    for tag in tags:
        with tempfile.TemporaryDirectory() as tmp:
            cfg, sizing, knobs = point_path(tag, tmp)
        spec = spec_from_yaml(cfg, kf_ring_capacity=256, **sizing, **knobs)
        for mesh in point_meshes():
            F, P = len(mesh), len(mesh[0])
            fstep = pb.make_fleet_step(spec)
            carry = pb.init_fleet_carry(spec, F, device=dev)
            ref, one_s = [], []
            for k, s_ in enumerate(sub):
                t1 = time.time()
                carry, out = fstep(carry, pb.pack_scans(spec, [s_] * F, [traj.stamps[k]] * F, device=dev))
                ref.append(host_fields(out))
                one_s.append(time.time() - t1)
            del carry
            torch.cuda.empty_cache()  # the cells share the card with this process on a one-card mesh
            t1 = time.time()
            with pb.PointShardedFleet(spec, mesh, answer_s=POINT_ANSWER_S) as fleet:
                start_s = time.time() - t1
                got, split_s, colls = [], [], []
                for k, s_ in enumerate(sub):
                    t1 = time.time()
                    got.append(fleet.step([s_] * F, [traj.stamps[k]] * F))
                    split_s.append(time.time() - t1)
                    colls.append(fleet.collectives[0])
                    if any(len(set(row)) != 1 for row in fleet.map_hashes):
                        raise AssertionError(f"point axis {tag}: map replicas differ at scan {k}: {fleet.map_hashes}")
                here = collections.Counter()
                for cell in fleet.launches:
                    here.update(cell)
                launches.update(here)
                backend = fleet.backend
            worst = 0.0
            for k, (g, r) in enumerate(zip(got, ref)):
                for f in r:
                    exact = tag in POINT_EXACT or f in POINT_INTEGERS or f == "stamp"
                    d = np.abs(getattr(g, f).astype(np.float64) - r[f].astype(np.float64))
                    if exact and not np.array_equal(getattr(g, f), r[f]):
                        raise AssertionError(f"point axis {tag} {F}x{P}: {f} at scan {k} differs from the "
                                             f"one-process fleet's ({d.max()})")
                    if f in ("pose_R", "pose_t"):
                        worst = max(worst, float(d.max()))
            if worst > POINT_POSE_TOL:
                raise AssertionError(f"point axis {tag} {F}x{P}: poses {worst:.3g} from the one-process fleet's "
                                     f"(bound {POINT_POSE_TOL})")
            if not all(g.accepted.all() for g in got[1:]):
                raise AssertionError(f"point axis {tag} {F}x{P}: a frame was not accepted")
            per_step = {kind: [list(c.get(kind, (0, 0))) for c in colls] for kind in ("all_reduce", "all_gather")}
            log(f"point axis {tag}: fleet {F} x point {P} over {backend} on {sorted({d for row in mesh for d in row})}, "
                f"{spec.raw_capacity // P} points of each scan per cell: "
                + ("every output equals the one-process fleet's bit for bit" if tag in POINT_EXACT else
                   f"every integer output equals the one-process fleet's, poses within {worst:.3g} "
                   f"(bound {POINT_POSE_TOL})")
                + f" over {len(sub)} scans; map replicas equal on every cell after every scan")
            log(f"point axis {tag} {F}x{P}: collectives of cell 0 per scan [calls, bytes]: {json.dumps(per_step)}")
            log(f"point axis {tag} {F}x{P}: kernels launched in the {F * P} cells {dict(here)}")
            log(f"point axis {tag} {F}x{P}: seconds per scan {[round(x, 4) for x in split_s]} (median of scans "
                f"1..{len(sub) - 1}: {np.median(split_s[1:]):.4f}; cells started in {start_s:.1f} s) against "
                f"{[round(x, 4) for x in one_s]} (median {np.median(one_s[1:]):.4f}) for the one-process fleet "
                f"of {F} instance(s) on {dev}"
                + ("; one card: the split and the merge, not the scaling" if backend == "gloo" else ""))
    log(f"point axis: phase 12 took {time.time() - t_phase:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# phase 13: the measuring tools — the trace, the stage split, the accuracy
# table, and the multi-LiDAR grouping
# ---------------------------------------------------------------------------

TOOL_SCANS = 16  # the trace's 10 warm-up and 6 profiled steps; the accuracy table takes the first 12
CROSS_FRAMES = 12
TRACE_KERNELS = ("capture_gather_kernel", "reselect_kernel", "align_kernel")  # B1-B3 on the bench step
CROSS_BAND = 0.03  # docs/benchmarks.md:321, "run-to-run band +-0.03"
# Each frame's float64 error against the JAX figure's (errors_f64 below).
# Set from the largest per-frame difference measured on an NVIDIA H100
# 80GB HBM3 at 700.00 W (2026-10-18): default 1.9e-4, rgbd 4.4e-5, intensity 5.6e-6,
# kissicp-like 2.2e-6, edges 1.3e-6, near-far 5.3e-7.  lidar3d-ndt's and
# dual-map's poses part from the JAX package's by up to 3.7e-3 and 3.2e-3
# (frames 11 and 10; ndt's plane normals round apart from XLA's, ROADMAP
# C8; dual-map's cause is not traced, C4), and get 0.01.
CROSS_FRAME_TOL = 1e-3
CROSS_FRAME_TOL_APART = {"lidar3d-ndt.yaml": 0.01, "extras/lidar3d-dual-map.yaml": 0.01}
# Phase 13 (c) without the per-voxel view holds CROSS_PIPELINE_JAX_XLA to the
# same tolerances, save the frames named here.  lidar3d-dual-map's frame 5
# takes 24 iterations in the port (on the card and on a CPU alike) and 13 in
# the JAX package; the JAX package stepped from the port's own carry after
# frame 4 (7.0e-8 m apart, C4's rounding) takes 24 too and lands 1.9e-7 m
# from the port, while the port stepped from the JAX package's carry agrees
# with it to 1.5e-8 m and to the iteration at every frame:
#     JAX_PLATFORMS=cpu PYTHONPATH=. python tests/phase13_cpu_figures.py jax-fork extras/lidar3d-dual-map.yaml --frames 6
# So the reference itself forks there, and frames 8-11 inherit the fork:
# measured 1.1e-2 to 1.8e-2 apart on an NVIDIA H100 80GB HBM3 at 700.00 W.
# lidar3d-default's frame 11 forks the same way (41 iterations against 38;
# the JAX package from the port's carry, 1.8e-6 m apart, takes 41 and lands
# 1.2e-7 m from the port; from the JAX carry the port takes 38, 3.7e-9 m
# from it; `jax-fork lidar3d-default.yaml --frames 12`) and read 3.0e-3.
CROSS_FULL_VOXEL_FRAMES_APART = {
    "lidar3d-default.yaml": {11: 0.01},
    "extras/lidar3d-dual-map.yaml": {8: 0.03, 9: 0.03, 10: 0.03, 11: 0.03},
}
# The worst gauge-aligned error per pipeline of docs/benchmarks.md:305-334
# (the JAX package, 12 frames, 3 m/s^2), printed beside the figures held.
CROSS_PIPELINE_DOCS = {
    "rgbd.yaml": 0.044, "lidar3d-ndt.yaml": 0.129, "extras/lidar3d-intensity.yaml": 0.218,
    "lidar3d-default.yaml": 0.220, "extras/lidar3d-dual-map.yaml": 0.269, "extras/lidar3d-edges.yaml": 0.274,
    "extras/lidar3d-kissicp-like.yaml": 0.346, "extras/lidar3d-near-far.yaml": 0.355,
}
# The JAX package's unchanged script on a CPU with its CPU defaults, one
# process per pipeline (JAX_PLATFORMS=cpu python eval/cross_pipeline.py
# --pipelines <yaml>; 2026-10-18, 8 cores, 14.4 min for the eight, each
# process's seconds beside it): the worst error as it printed it (3
# decimals) and the per-frame errors its stderr printed (4).  On a CPU the
# JAX package captures every point of each probed voxel and selects in XLA
# (``use_pallas`` and ``per_voxel_nn`` off); the port runs it with
# per_voxel_nn off, and phase 13 (c) holds that run to these figures as it
# holds the per-voxel run to CROSS_PIPELINE_JAX.  errors_f64: each frame's
# error in float64 from the JAX poses, made by
#     JAX_PLATFORMS=cpu PYTHONPATH=. python tests/phase13_cpu_figures.py jax-cross <yaml> --cpu-defaults
# (two at a time on 8 cores, 184-364 s each, 18 min for the eight), whose
# float32 errors equal the ones above to every printed digit.
CROSS_PIPELINE_JAX_XLA = {
    "lidar3d-default.yaml": dict(  # 92 s
        worst=0.204, errors=[0.0, 0.0031, 0.0155, 0.0508, 0.1125, 0.1611, 0.1774, 0.2044, 0.1612, 0.1065, 0.0765, 0.0779],
        errors_f64=[0.000000, 0.003073, 0.015463, 0.050814, 0.112496, 0.163688, 0.174249, 0.203215, 0.161394, 0.105531, 0.076737, 0.077936]),
    "lidar3d-ndt.yaml": dict(  # 81 s
        worst=0.119, errors=[0.0, 0.0412, 0.0497, 0.054, 0.079, 0.1195, 0.098, 0.0943, 0.079, 0.0574, 0.0669, 0.055],
        errors_f64=[0.000000, 0.041246, 0.049713, 0.053985, 0.078971, 0.119452, 0.097988, 0.093143, 0.080149, 0.058233, 0.065833, 0.055159]),
    "rgbd.yaml": dict(  # 145 s
        worst=0.046, errors=[0.0, 0.0038, 0.0099, 0.0044, 0.0093, 0.0154, 0.0327, 0.0261, 0.0314, 0.0368, 0.0456, 0.0265],
        errors_f64=[0.000000, 0.003771, 0.009871, 0.004440, 0.009310, 0.015409, 0.033086, 0.026294, 0.031547, 0.036615, 0.045674, 0.026540]),
    "extras/lidar3d-kissicp-like.yaml": dict(  # 81 s
        worst=0.342, errors=[0.0, 0.0026, 0.0174, 0.0532, 0.1243, 0.236, 0.2826, 0.3423, 0.294, 0.2716, 0.2567, 0.2532],
        errors_f64=[0.000000, 0.002558, 0.017450, 0.053196, 0.124344, 0.232450, 0.282906, 0.333884, 0.293346, 0.271664, 0.257606, 0.253155]),
    "extras/lidar3d-dual-map.yaml": dict(  # 104 s
        worst=0.212, errors=[0.0, 0.0018, 0.0175, 0.0554, 0.1146, 0.1741, 0.179, 0.2118, 0.1525, 0.1426, 0.1228, 0.1143],
        errors_f64=[0.000000, 0.001824, 0.017471, 0.055431, 0.114562, 0.169462, 0.181811, 0.212034, 0.152400, 0.142399, 0.122890, 0.114201]),
    "extras/lidar3d-near-far.yaml": dict(  # 110 s
        worst=0.354, errors=[0.0, 0.0, 0.03, 0.0831, 0.1623, 0.2717, 0.3544, 0.2205, 0.1496, 0.1206, 0.1037, 0.096],
        errors_f64=[0.000000, 0.000000, 0.030001, 0.081875, 0.160627, 0.270490, 0.354600, 0.224165, 0.150049, 0.119234, 0.103774, 0.096126]),
    "extras/lidar3d-edges.yaml": dict(  # 128 s
        worst=0.277, errors=[0.0, 0.0017, 0.0174, 0.0512, 0.1122, 0.176, 0.2261, 0.2774, 0.2367, 0.208, 0.2013, 0.211],
        errors_f64=[0.000000, 0.001663, 0.017383, 0.052579, 0.112158, 0.177864, 0.224236, 0.277410, 0.236088, 0.207107, 0.200795, 0.210739]),
    "extras/lidar3d-intensity.yaml": dict(  # 121 s
        worst=0.161, errors=[0.0, 0.0057, 0.0146, 0.0519, 0.1025, 0.1369, 0.1356, 0.1609, 0.0887, 0.0675, 0.0556, 0.0611],
        errors_f64=[0.000000, 0.005742, 0.014578, 0.051908, 0.102508, 0.139362, 0.133543, 0.162261, 0.088524, 0.067758, 0.055592, 0.061143]),
}
# The figures phase 13 (c) holds: the JAX package running the algorithm the
# port runs (its TPU algorithm), driven as eval/cross_pipeline.py drives it:
#     JAX_PLATFORMS=cpu PYTHONPATH=. python tests/phase13_cpu_figures.py jax-cross <yaml>
# which sets the knobs of that script's KNOBS table: MOLA_TPU_PALLAS=0
# MOLA_TPU_PER_VOXEL_NN=1 (the per-voxel capture and the XLA twin of the
# planar select) for the generic-loop pipelines, MOLA_TPU_PALLAS=1
# MOLA_TPU_PER_VOXEL_NN=1 MOLA_TPU_PALLAS_CAPTURE=1 (the Pallas kernels in
# interpret mode) for the fused ones ("generic" and "fused" beside each,
# with the process's seconds, three at a time on 8 cores, 2026-10-18).  The
# unchanged eval script with the same knobs printed the same worst and
# per-frame float32 errors.  errors_f64: each frame's error in float64 from
# the JAX poses (apps/cross_pipeline.gt_error_f64), free of the float32
# metric's noise (ROADMAP C16).
CROSS_PIPELINE_JAX = {
    "lidar3d-default.yaml": dict(  # 289 s fused
        worst=0.228, errors=[0.0, 0.003, 0.0154, 0.0509, 0.1124, 0.179, 0.1962, 0.2281, 0.1847, 0.1576, 0.1272, 0.1254],
        errors_f64=[0.000000, 0.003048, 0.015385, 0.050875, 0.112413, 0.178983, 0.198157, 0.228129, 0.184678, 0.158981, 0.127070, 0.125316]),
    "lidar3d-ndt.yaml": dict(  # 308 s generic
        worst=0.119, errors=[0.0, 0.0412, 0.0497, 0.054, 0.079, 0.1195, 0.098, 0.0943, 0.079, 0.0574, 0.0669, 0.055],
        errors_f64=[0.000000, 0.041246, 0.049713, 0.053985, 0.078971, 0.119452, 0.097988, 0.093143, 0.080149, 0.058233, 0.065833, 0.055159]),
    "rgbd.yaml": dict(  # 431 s generic
        worst=0.046, errors=[0.0, 0.0038, 0.0099, 0.0044, 0.0093, 0.0154, 0.0327, 0.0261, 0.0314, 0.0368, 0.0456, 0.0265],
        errors_f64=[0.000000, 0.003771, 0.009871, 0.004440, 0.009310, 0.015409, 0.033086, 0.026294, 0.031547, 0.036615, 0.045674, 0.026540]),
    "extras/lidar3d-kissicp-like.yaml": dict(  # 207 s fused
        worst=0.336, errors=[0.0, 0.0026, 0.0175, 0.0532, 0.1243, 0.237, 0.281, 0.3364, 0.3154, 0.3077, 0.282, 0.2668],
        errors_f64=[0.000000, 0.002558, 0.017450, 0.053198, 0.124344, 0.232202, 0.283263, 0.347447, 0.315707, 0.306223, 0.283326, 0.267005]),
    "extras/lidar3d-dual-map.yaml": dict(  # 346 s generic
        worst=0.268, errors=[0.0, 0.0018, 0.0175, 0.0558, 0.1179, 0.1889, 0.2229, 0.2683, 0.264, 0.254, 0.2357, 0.2309],
        errors_f64=[0.000000, 0.001824, 0.017483, 0.055849, 0.117856, 0.188925, 0.226755, 0.266531, 0.264709, 0.254353, 0.235570, 0.230321]),
    "extras/lidar3d-near-far.yaml": dict(  # 348 s generic
        worst=0.385, errors=[0.0, 0.0, 0.03, 0.0831, 0.1629, 0.2672, 0.3631, 0.3798, 0.3804, 0.3711, 0.3714, 0.385],
        errors_f64=[0.000000, 0.000000, 0.030001, 0.081875, 0.160682, 0.270597, 0.365073, 0.379677, 0.382711, 0.376661, 0.370979, 0.384091]),
    "extras/lidar3d-edges.yaml": dict(  # 330 s generic
        worst=0.277, errors=[0.0, 0.0017, 0.0174, 0.0512, 0.1122, 0.176, 0.2261, 0.2774, 0.2367, 0.208, 0.2013, 0.211],
        errors_f64=[0.000000, 0.001663, 0.017383, 0.052579, 0.112158, 0.177865, 0.224236, 0.277410, 0.236089, 0.207108, 0.200796, 0.210740]),
    "extras/lidar3d-intensity.yaml": dict(  # 356 s generic
        worst=0.223, errors=[0.0, 0.0057, 0.0151, 0.0525, 0.1053, 0.173, 0.1845, 0.2227, 0.208, 0.1911, 0.1598, 0.1471],
        errors_f64=[0.000000, 0.005742, 0.015064, 0.052479, 0.105266, 0.173035, 0.188808, 0.222120, 0.207779, 0.189879, 0.159143, 0.146910]),
}
# Phase 13 (d)'s references, made by tests/phase13_cpu_figures.py over the
# same scans at SIZING: the port on the CPU (port-multi-lidar; no JAX in the
# process) and the JAX package's LidarOdometry and async runtime with the
# knobs of its TPU algorithm (jax-multi-lidar).
MULTI_LIDAR_CPU = dict(  # 143 s on 8 cores, 0.19-0.41 s a group
    iterations=[0, 6, 7, 23, 26, 29, 13, 25],
    quality=[1.0, 1.0, 0.9990384578704834, 0.9952426552772522,
             0.9923481345176697, 0.9740009903907776, 0.9971536993980408, 0.9862232804298401],
    final_pose_gt_error=0.1834018975496292,
)
MULTI_LIDAR_JAX = dict(  # 126 s on 8 cores
    iterations=[0, 6, 7, 22, 26, 25, 23, 25],
    quality=[1.0, 1.0, 0.9990384578704834, 0.9952426552772522,
             0.9923481345176697, 0.9740009903907776, 0.9971536993980408, 0.9862232804298401],
    final_pose_gt_error=0.1864272654056549,
)


def phase_multi_lidar(dev, scans, traj):
    """Phase 13 (d): apps/multi_lidar.py on the card over the bench scans
    (two half-scan sensors 5 ms apart grouped by the async runtime), every
    group formed, every frame accepted, mean quality (frames 1 on) and
    final-pose GT error within QUALITY_SPREAD / GT_SPREAD of MULTI_LIDAR_CPU
    and MULTI_LIDAR_JAX."""
    from mola_lidar_odometry_tpu_torch.apps import multi_lidar as ml

    r = ml.run(dev, scans, traj, SIZING)
    q = float(np.mean(r["quality"][1:]))
    log(f"multi-LiDAR: 2 sensors x {len(scans)} scans -> {r['groups']} groups ({r['dropped']} dropped), points per "
        f"group {r['points']}; iterations {r['iterations']}; mean quality {q:.4f}; final-pose GT error "
        f"{r['final_pose_gt_error']:.4f}; {1e3 * np.median(r['secs'][1:]):.1f} ms per group (median after the first)")
    failures = []
    if r["groups"] != len(scans) or r["dropped"]:
        failures.append(f"{r['groups']} groups of {len(scans)} scans, {r['dropped']} dropped")
    if not all(r["accepted"][1:]):
        failures.append(f"frames not accepted: {[k for k, a in enumerate(r['accepted']) if not a]}")
    for tag, ref in (("the port's CPU run", MULTI_LIDAR_CPU), ("the JAX package's CPU run", MULTI_LIDAR_JAX)):
        q_ref = float(np.mean(ref["quality"][1:]))
        log(f"multi-LiDAR: {tag}: iterations {ref['iterations']}; mean quality {q_ref:.4f}; final-pose GT error "
            f"{ref['final_pose_gt_error']:.4f}")
        if not abs(q - q_ref) <= QUALITY_SPREAD:
            failures.append(f"mean quality {q:.4f} is more than {QUALITY_SPREAD} from {tag}'s {q_ref:.4f}")
        if not abs(r["final_pose_gt_error"] - ref["final_pose_gt_error"]) <= GT_SPREAD:
            failures.append(f"final-pose GT error {r['final_pose_gt_error']:.4f} is more than {GT_SPREAD} from "
                            f"{tag}'s {ref['final_pose_gt_error']:.4f}")
    if failures:
        raise AssertionError("multi-LiDAR: " + "; ".join(failures))


def cross_full_voxel(dev, sub, tr, intens) -> list:
    """Phase 13 (c) without the per-voxel view (per_voxel_nn off: every
    point of each probed voxel, the generic loop on B4), the JAX package's
    algorithm on a CPU: each pipeline held to CROSS_PIPELINE_JAX_XLA, its
    worst error within CROSS_BAND and each frame's float64 error within
    CROSS_FRAME_TOL (or CROSS_FRAME_TOL_APART, or the frame's own in
    CROSS_FULL_VOXEL_FRAMES_APART).  Returns the failures."""
    import torch

    from mola_lidar_odometry_tpu_torch.apps import cross_pipeline as cp

    failures = []
    for name in cp.PIPELINES:
        r = cp.run_pipeline(os.path.join(cp.ROOT, name), sub, tr, intens, cp.CAPS, dev, per_voxel_nn=False)
        torch.cuda.empty_cache()
        ref = CROSS_PIPELINE_JAX_XLA[name]
        d64 = np.abs(np.subtract(r["errors_f64"], ref["errors_f64"]))
        tol = np.full(len(d64), CROSS_FRAME_TOL_APART.get(name, CROSS_FRAME_TOL))
        for k, t in CROSS_FULL_VOXEL_FRAMES_APART.get(name, {}).items():
            tol[k] = t
        log(f"tools: cross full voxel {name}: worst {r['worst']:.4f} (JAX's CPU algorithm {ref['worst']:.4f}, band "
            f"{CROSS_BAND}; the per-voxel view {CROSS_PIPELINE_JAX[name]['worst']:.4f}); float64 metric "
            f"{r['worst_f64']:.4f}; errors {[round(e, 4) for e in r['errors']]}; iterations {r['iterations']}; "
            f"quality {[round(q, 3) for q in r['quality']]}; {np.mean(r['secs'][1:]):.3f} s/frame after frame 0; "
            f"float64 differences from JAX's per frame {[float(f'{d:.2e}') for d in d64]} (tolerance "
            f"{tol[0]:g}" + "".join(f", frame {k} {t:g}" for k, t in CROSS_FULL_VOXEL_FRAMES_APART.get(name, {}).items())
            + ")")
        if not abs(r["worst"] - ref["worst"]) <= CROSS_BAND:
            failures.append(f"{name} full voxel worst {r['worst']:.4f} outside the {CROSS_BAND} band of "
                            f"{ref['worst']:.4f}")
        if not (d64 <= tol).all():
            failures.append(f"{name} full voxel float64 errors of frames {np.flatnonzero(d64 > tol).tolist()} more "
                            f"than their tolerance from JAX's")
    return failures


def phase_tools(dev, scans, traj):
    """Phase 13 (see the module docstring): (a) apps/trace_step.py on the
    bench configuration, (b) apps/profile_stages.py at B = 1 and B = 8, (c)
    apps/cross_pipeline.py over the eight 3D pipelines held to
    CROSS_PIPELINE_JAX, (d) the multi-LiDAR grouping.  Returns each
    kernel's launches in this phase."""
    import tempfile

    import torch

    from mola_lidar_odometry_tpu_torch.apps import bench_sequence as bs
    from mola_lidar_odometry_tpu_torch.apps import cross_pipeline as cp, profile_stages as ps, trace_step as ts

    t_phase = time.time()
    wrappers = ps.kernel_wrappers()
    names = {"B1": "capture_planar", "B2": "capture_planar_reselect", "B3": "align_fused", "B4": "nn_select"}
    for w in wrappers.values():
        w.launches = 0

    # (a) the trace: 10 warm-up steps, 6 profiled, B = 8
    with tempfile.TemporaryDirectory() as out:
        targs = ts.build_parser().parse_args(["--out", out])
        rep = ts.run(targs, dev, (scans, traj))
    rows, steps = rep["rows"], rep["steps"]
    log(f"tools: trace: {steps} profiled steps of lidar3d-default at B={targs.batch} after {targs.warmup} warm-up "
        f"steps: device {rep['total_us'] / 1e3 / steps:.3f} ms/step in {rep['device_ops'] / steps:g} device ops/step; "
        f"busy union {rep['busy_us'] / 1e3:.3f} ms of the {rep['wall_ms']:.3f} ms profiled window "
        f"({100 * rep['busy_us'] / 1e3 / rep['wall_ms']:.1f}% busy), {rep['wall_ms'] / steps:.3f} ms/step profiled "
        f"against {rep['plain_step_ms']:.3f} ms for the last warm-up step unprofiled")
    for name, us, n in rows[:15]:
        sites = "; ".join(f"{s} {s_us / 1e3 / steps:.3f}" for s, s_us in rep["sites"][name][:2] if s)
        log(f"tools: trace:   {us / 1e3 / steps:8.3f} ms/step {100 * us / rep['total_us']:5.1f}% x{n / steps:g} "
            f"{name[:80]} <- {sites or '(no Python frame)'}")
    for (pid, tid), g in rep["lines"].items():
        log(f"tools: trace: device line {pid}/{tid}: {g['events']} events, span {g['span'] / 1e3:.3f} ms, busy "
            f"{g['busy'] / 1e3:.3f} ms, idle {g['idle'] / 1e3:.3f} ms ({100 * g['idle'] / g['span']:.1f}%), "
            f"idle/step {g['idle'] / 1e3 / steps:.3f} ms; largest gaps: "
            + ", ".join(f"{gap / 1e3:.3f} ms before {nxt[:60]}" for gap, _, nxt in g["gaps"][:5]))
        log(f"tools: trace: device line {pid}/{tid}: idle by the op that follows: "
            + ", ".join(f"{nxt[:60]} {gap / 1e3:.3f} ms" for nxt, gap in g["idle_by_next"][:5]))
        log(f"tools: trace: device line {pid}/{tid}: idle by the source that launched the op that follows: "
            + ", ".join(f"{site} {gap / 1e3:.3f} ms" for site, gap in g.get("idle_by_next_site", [])[:8]))
    missing = [k for k in TRACE_KERNELS if not any(k in r[0] for r in rows)]
    if missing:
        raise AssertionError(f"tools: trace: {missing} not among the aggregated device events")
    for k in TRACE_KERNELS:
        row = next(r for r in rows if k in r[0])
        log(f"tools: trace: {k}: {row[1] / 1e3 / steps:.4f} ms/step x{row[2] / steps:g}, sites "
            + "; ".join(s for s, _ in rep["sites"][row[0]][:2]))

    # (b) the stage split at B = 1 and B = 8
    for b in (1, 8):
        t1 = time.time()
        out = io.StringIO()
        ps.run(ps.build_parser().parse_args(["--batch", str(b)]), dev, out=out)
        for line in out.getvalue().splitlines():
            log(f"tools: stages B={b}: {line}")
        torch.cuda.empty_cache()
        log(f"tools: stages B={b}: {time.time() - t1:.1f} s")

    # (c) the accuracy table over the first 12 scans
    sub, tr = scans[:CROSS_FRAMES], bs.head(traj, CROSS_FRAMES)
    intens = bs.scan_intensities(sub)
    failures = []
    for name in cp.PIPELINES:
        r = cp.run_pipeline(os.path.join(cp.ROOT, name), sub, tr, intens, cp.CAPS, dev)
        torch.cuda.empty_cache()
        ref = CROSS_PIPELINE_JAX[name]["worst"]
        log(f"tools: cross {name}: worst {r['worst']:.4f} (JAX, the same algorithm {ref:.4f}, band {CROSS_BAND}; JAX's "
            f"CPU algorithm {CROSS_PIPELINE_JAX_XLA[name]['worst']:.4f}; docs {CROSS_PIPELINE_DOCS[name]:.3f}); "
            f"float64 metric {r['worst_f64']:.4f}; errors {[round(e, 4) for e in r['errors']]}; "
            f"iterations {r['iterations']}; quality {[round(q, 3) for q in r['quality']]}; "
            f"{np.mean(r['secs'][1:]):.3f} s/frame after frame 0")
        if not abs(r["worst"] - ref) <= CROSS_BAND:
            failures.append(f"{name} worst {r['worst']:.4f} outside the {CROSS_BAND} band of {ref:.4f}")
        d64 = np.abs(np.subtract(r["errors_f64"], CROSS_PIPELINE_JAX[name]["errors_f64"]))
        tol = CROSS_FRAME_TOL_APART.get(name, CROSS_FRAME_TOL)
        log(f"tools: cross {name}: float64 errors {[round(e, 4) for e in r['errors_f64']]}; largest per-frame "
            f"difference from JAX's {d64.max():.2e} at frame {int(d64.argmax())} (tolerance {tol})")
        if not d64.max() <= tol:
            failures.append(f"{name} float64 errors of frames {np.flatnonzero(d64 > tol).tolist()} more than "
                            f"{tol} from JAX's")
    failures += cross_full_voxel(dev, sub, tr, intens)
    if failures:
        raise AssertionError("tools: cross-pipeline: " + "; ".join(failures))

    # (d) the multi-LiDAR grouping over the 8 scans of phases 4-12
    phase_multi_lidar(dev, scans[:N_SCANS], bs.head(traj, N_SCANS))
    launches = {names[k]: w.launches for k, w in wrappers.items()}
    log(f"tools: launches in phase 13 {launches}; phase 13 took {time.time() - t_phase:.1f} s")
    return launches


def host_fields(out) -> dict:
    """A StepOutput's fields on the host as numpy arrays."""
    return {f: v.cpu().numpy() for f, v in zip(out._fields, out)}


def phase_paths(dev, recs, seq_scans, seq_traj):
    """Phases 4-13: phases 4-12 over the first N_SCANS of the bench's
    simulated sequence ``seq_scans`` (and lidar2d's 2D scans), phase 13 over
    all of it; fills ``launches`` of every record with the sum over them."""
    from mola_lidar_odometry_tpu_torch.apps import bench_sequence as bs

    scans, traj = seq_scans[:N_SCANS], bs.head(seq_traj, N_SCANS)
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
    l11 = phase_complete(dev, recs, scans, traj)
    l12 = phase_point_axis(dev, scans, traj)
    l13 = phase_tools(dev, seq_scans, seq_traj)
    for r in recs:
        r["launches"] = sum(ls.get(r["name"], 0)
                            for ls in (main_l, dual_l, host_l, ndt_l, extra_l, l9, l10, l11, l12, l13))
        del r["wrapper"]
    never = [r["name"] for r in recs if r["launches"] <= 0]
    if never:
        raise AssertionError(f"kernels never launched on any path: {never}")


def phase_full_voxel(dev, seq_scans, seq_traj):
    """The full-voxel parts of phases 3, 11 and 13 (c) alone: B4 at the
    full-voxel widths, phase 11's full-voxel paths over the first N_SCANS
    scans, and the eight pipelines without the per-voxel view over the first
    CROSS_FRAMES.  Returns each kernel's launches."""
    from mola_lidar_odometry_tpu_torch.apps import bench_sequence as bs
    from mola_lidar_odometry_tpu_torch.apps.profile_stages import kernel_wrappers

    wrappers = kernel_wrappers()
    names = {"B1": "capture_planar", "B2": "capture_planar_reselect", "B3": "align_fused", "B4": "nn_select"}
    recs = [dict(name=names[k], wrapper=w, max_abs_err=0.0) for k, w in wrappers.items()]
    phase_kernel_match_full_voxel(dev)
    launches = collections.Counter(phase_complete(dev, recs, seq_scans[:N_SCANS], bs.head(seq_traj, N_SCANS),
                                                  tags=COMPLETE_FULL_VOXEL, rest=False))
    for w in wrappers.values():
        w.launches = 0
    sub, tr = seq_scans[:CROSS_FRAMES], bs.head(seq_traj, CROSS_FRAMES)
    failures = cross_full_voxel(dev, sub, tr, bs.scan_intensities(sub))
    if failures:
        raise AssertionError("full voxel: cross-pipeline: " + "; ".join(failures))
    launches.update({names[k]: w.launches for k, w in wrappers.items()})
    log(f"full voxel: launches {dict(launches)}")
    return launches


def phase_dispatch(dev, seq_scans, seq_traj):
    """The dispatch parts of phases 3, 11 and 12 alone: B3 on the plain
    capture and B1/B2 at 4 and 1 probes, phase 11's "k200 dedup" and
    COMPLETE_DISPATCH paths over the first N_SCANS scans, and phase 12's
    two C14 paths.  Returns each kernel's launches."""
    from mola_lidar_odometry_tpu_torch.apps import bench_sequence as bs
    from mola_lidar_odometry_tpu_torch.apps.profile_stages import kernel_wrappers

    wrappers = kernel_wrappers()
    names = {"B1": "capture_planar", "B2": "capture_planar_reselect", "B3": "align_fused", "B4": "nn_select"}
    recs = [dict(name=names[k], wrapper=w, max_abs_err=0.0) for k, w in wrappers.items()]
    phase_kernel_dispatch(dev, recs)
    scans, traj = seq_scans[:N_SCANS], bs.head(seq_traj, N_SCANS)
    launches = collections.Counter(phase_complete(dev, recs, scans, traj, tags=("k200 dedup",) + COMPLETE_DISPATCH,
                                                  rest=False))
    launches.update(phase_point_axis(dev, scans, traj, tags=POINT_PATHS[2:]))
    log(f"dispatch: launches {dict(launches)}; max |d| against the twins "
        f"{ {r['name']: r['max_abs_err'] for r in recs} }")
    return launches


def simulate(n: int):
    """The first ``n`` scans of the bench's sequence (apps/bench_sequence.py),
    simulated by one spawned process per CPU core."""
    from mola_lidar_odometry_tpu_torch.apps import bench_sequence as bs

    t0 = time.time()
    scans, traj = bs.gen_scans(n)
    log(f"main: simulated {n} scans of {len(scans[0][0])} rays in {time.time() - t0:.1f} s (host, "
        f"{min(n, os.cpu_count() or 1)} processes)")
    return scans, traj


def main():
    import argparse

    import torch

    ap = argparse.ArgumentParser(description="Smoke run of the PyTorch/CUDA port on the GPU")
    ap.add_argument("--only-point-axis", action="store_true", help="phases 1, 2 and 12 only (no kernels line)")
    ap.add_argument("--only-tools", action="store_true", help="phases 1, 2 and 13 only (no kernels line)")
    ap.add_argument("--only-full-voxel", action="store_true",
                    help="phases 1, 2 and the full-voxel parts of 3, 11 and 13 (c) only (no kernels line)")
    ap.add_argument("--only-dispatch", action="store_true",
                    help="phases 1, 2 and the ICP dispatch's parts of 3, 11 and 12 only (no kernels line)")
    args = ap.parse_args()
    phase_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    if args.only_point_axis or args.only_tools or args.only_full_voxel or args.only_dispatch:
        if args.only_dispatch:
            launches = phase_dispatch("cuda", *simulate(N_SCANS))
            never = [k for k in MAIN_KERNELS + DUALMAP_KERNELS if launches.get(k, 0) <= 0]
        elif args.only_full_voxel:
            launches = phase_full_voxel("cuda", *simulate(CROSS_FRAMES))
            never = [k for k in DUALMAP_KERNELS if launches.get(k, 0) <= 0]
        elif args.only_point_axis:
            launches = phase_point_axis("cuda", *simulate(POINT_SCANS))
            never = [k for k, v in launches.items() if v <= 0]
        else:
            launches = phase_tools("cuda", *simulate(TOOL_SCANS))
            never = [k for k in MAIN_KERNELS + DUALMAP_KERNELS if launches.get(k, 0) <= 0]
        if never:
            raise AssertionError(f"kernels never launched in the phase: {never}")
        print(card_line(), flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
        }}), flush=True)
        return
    recs = phase_kernels("cuda")
    phase_kernel_windows("cuda")
    recs.append(phase_kernel_match("cuda"))
    phase_kernel_match_full_voxel("cuda", recs[-1])
    phase_kernel_dispatch("cuda", recs)
    phase_paths("cuda", recs, *simulate(TOOL_SCANS))
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in recs]}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
