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

Then one JSON line describing every kernel (launches summed over both
paths), the card's name and power limit, and last the JSON result line.  Any
failure raises and exits non-zero.  It imports nothing of JAX and nothing of
the JAX package.
"""

from __future__ import annotations

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


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]


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
    ranked = sorted(evs, key=dev_us, reverse=True)
    own = ("capture_gather_kernel", "reselect_kernel", "align_kernel", "nn_select_kernel")  # wherever they rank
    for e in ranked[:12] + [e for e in ranked[12:] if any(k in e.key for k in own)]:
        log(f"profile:   {dev_us(e) / 1e3:8.3f} ms  x{e.count:<5d} {e.key[:90]}")
    return carry, out


def run_fleet(dev, recs, tag, pipeline, sizing, scans, traj, guards, map_names):
    """Step the B=8 fleet of ``pipeline`` through ``scans`` on the kernels
    with every launch count set to 0 just before and read just after;
    returns (scans/s, launches of this path per kernel name)."""
    import torch

    from mola_lidar_odometry_tpu_torch.models.spec import spec_from_yaml
    from mola_lidar_odometry_tpu_torch.ops import se3
    from mola_lidar_odometry_tpu_torch.parallel import batch as pb
    from mola_lidar_odometry_tpu_torch.utils.config import load_yaml_file

    n_scans = len(scans)
    cfg = load_yaml_file(os.path.join(HERE, "pipelines", pipeline), env={})
    spec = spec_from_yaml(cfg, kf_ring_capacity=256, **sizing)
    fstep = pb.make_fleet_step(spec)
    seq = [pb.pack_scans(spec, [s] * BATCH, [traj.stamps[k]] * BATCH, device=dev) for k, s in enumerate(scans)]
    carry = pb.init_fleet_carry(spec, BATCH, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    for r in recs:
        r["wrapper"].launches = 0
    outs, secs = [], []
    for k in range(n_scans - 1):
        t1 = time.time()
        carry, out = fstep(carry, seq[k])
        torch.cuda.synchronize()
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
    G = lambda k: se3.Pose(torch.tensor(traj.R[k], dtype=torch.float32), torch.tensor(traj.t[k], dtype=torch.float32))  # noqa: E731
    est = se3.Pose(carry.pose_R[0].cpu(), carry.pose_t[0].cpu())
    gt_err = float(torch.linalg.norm(se3.se3_log(se3.relative(se3.relative(G(0), G(n_scans - 1)), est))))
    icp_cap = sizing["layer_capacities"][spec.icp_local_layer]
    map_cap = sizing["layer_capacities"][spec.map_inserts[0].input_layer]
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
    failures = []
    if not accepted[1:].all():
        failures.append(f"frames not accepted: {np.argwhere(~accepted).tolist()}")
    if not q[1:].mean() > guards["min_mean_quality"]:
        failures.append(f"mean quality {q[1:].mean():.3f} <= {guards['min_mean_quality']}")
    if not gt_err < guards["max_gt_error"]:
        failures.append(f"final-pose GT error {gt_err:.3f} >= {guards['max_gt_error']}")
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
    return sps, launches


def phase_paths(dev, recs):
    """Phases 4 and 5 over one simulated sequence; fills ``launches`` of every
    record with the sum over both paths."""
    t0 = time.time()
    scans, traj = bench_scans(N_SCANS)
    log(f"main: simulated {N_SCANS} scans of {len(scans[0][0])} rays in {time.time() - t0:.1f} s (host)")
    _, main_l = run_fleet(
        dev, recs, "main", "lidar3d-default.yaml", SIZING, scans, traj,
        dict(min_mean_quality=0.9, max_gt_error=0.20,
             kernels=("capture_planar", "capture_planar_reselect", "align_fused")),
        ("localmap",),
    )
    _, dual_l = run_fleet(
        dev, recs, "dual-map", os.path.join("extras", "lidar3d-dual-map.yaml"), DUALMAP_SIZING,
        scans[:DUALMAP_SCANS], traj, dict(DUALMAP_GUARDS, kernels=("nn_select",)), ("localmap", "localmap_far"),
    )
    for r in recs:
        r["launches"] = main_l[r["name"]] + dual_l[r["name"]]
        del r["wrapper"]
    never = [r["name"] for r in recs if r["launches"] <= 0]
    if never:
        raise AssertionError(f"kernels never launched on either path: {never}")


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
