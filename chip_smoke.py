#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line of numbers each:

  1. device  — the card's name and power limit, torch and CUDA versions;
               exits non-zero when no CUDA device is visible;
  2. build   — compiles the port's CUDA kernels from csrc/ (one nvcc per
               source, all at once) and reports the seconds;
  3. kernels — runs kernels B1, B2 and B3 at bench shapes (B=8 instances,
               3072 ICP points, 8 probes, 16 candidates, a 65536-slot K=20
               map filled by the port's insert) against their plain PyTorch
               twins on the card, in the order and with the arguments of one
               align on the main path (capture at an entry pose off the
               answer, phase 1 from iteration 0, reselect, phase 2 resuming
               the iteration count, a weighted prior, the twist hook firing
               for two instances): B1/B2 must match bit for bit, B3 within
               3e-3 on R and t, one iteration and 0.02 quality; times each;
  4. main    — steps the B=8 fleet of the lidar3d-default pipeline over the
               first 8 scans of the bench's simulated KITTI-like sequence
               (64 x 2048 rays) on the kernels, with the bench's round-5
               sizing; checks mean quality > 0.9, final-pose GT error < 0.20,
               no ICP-layer saturation, and that every kernel launched.

Then one JSON line describing every kernel, the card's name and power limit,
and last the JSON result line.  Any failure raises and exits non-zero.
It imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
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


def kernel_inputs(dev, seed=0, n_query=3072):
    """A bench-sized fleet map (65536 slots, K=20) filled by the port's
    insert, and per-instance ICP points near the mapped surfaces."""
    import torch

    from mola_lidar_odometry_tpu_torch.ops import voxel_hash as vh
    from mola_lidar_odometry_tpu_torch.ops.pointcloud import PointCloud

    rng = np.random.default_rng(seed)
    m = vh.VoxelHashMap.create(1 << 16, 20, 1.0, batch=BATCH, device=dev)
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


def phase_kernels(dev):
    """Hold each kernel against its plain twin on the card, called as one
    align of the main path calls them (``ops/icp.py::_align_fused_call``);
    returns the per-kernel records (launch counts come from the main path)."""
    import torch

    from mola_lidar_odometry_tpu_torch.ops import pallas_capture as pc, pallas_icp as pi, se3
    from mola_lidar_odometry_tpu_torch.ops.filters import voxel_coords, voxel_hash
    from mola_lidar_odometry_tpu_torch.ops.icp import _FUSED_REFRESH_AT
    from mola_lidar_odometry_tpu_torch.ops.voxel_hash import neighbor_coords

    m, local, valid = kernel_inputs(dev)
    B, N = valid.shape
    P, npad, C = 8, 3072, 16
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

    # B1 at the entry pose
    q0 = se3.transform(entry, local).contiguous()
    args1 = (m.data, m.voxel_size, m.epoch, q0, P)
    kw1 = dict(K=m.K, stride=m.stride, valid=valid, return_rows=True)
    ref1 = pc.capture_planar_plain(*args1, **kw1)
    got1 = pc.capture_planar(*args1, **kw1)
    torch.cuda.synchronize()
    for g, r, name in zip(got1, ref1, ("cx", "cy", "cz", "cm", "rows")):
        if not torch.equal(g, r):
            raise AssertionError(f"B1 {name} differs from its plain twin in {int((g != r).sum())} elements")
    err1 = max_err(got1, ref1)
    paired = float(got1[3][:, :P].sum()) / float(valid.sum())
    log(f"kernels: B1 bit-exact vs plain on {B}x{P}x{npad} probes (max |d| {err1}); {paired:.3f} "
        f"probed voxels with a candidate per valid query")

    # B3 phase 1: from the entry pose, it0 = 0, at most 8 iterations
    b1 = torch.clamp(budget, max=_FUSED_REFRESH_AT)
    args3a = (tuple(ref1[:4]), local, valid, entry.R, entry.t, prior.R, prior.t, info, thr, kc, b1)
    ref3a = pi.align_fused_plain(*args3a, it0=zero, **statics)
    got3a = pi.align_fused(*args3a, it0=zero, **statics)
    torch.cuda.synchronize()
    err3 = check_align("B3 phase 1", got3a, ref3a)
    R1, t1, it1, hook1 = ref3a[0], ref3a[1], ref3a[2], ref3a[3]

    # B2 at the settled pose, keys from the entry-pose queries
    q1 = se3.transform(se3.Pose(R1, t1), local).contiguous()
    args2 = (ref1[4], m.voxel_size, m.epoch, q1, q0, P)
    kw2 = dict(K=m.K, stride=m.stride, valid=valid)
    ref2 = pc.capture_planar_reselect_plain(*args2, **kw2)
    got2 = pc.capture_planar_reselect(*args2, **kw2)
    torch.cuda.synchronize()
    for g, r, name in zip(got2, ref2, ("cx", "cy", "cz", "cm")):
        if not torch.equal(g, r):
            raise AssertionError(f"B2 {name} differs from its plain twin in {int((g != r).sum())} elements")
    err2 = max_err(got2, ref2)
    log(f"kernels: B2 bit-exact vs plain (max |d| {err2})")

    # B3 phase 2: from phase 1's pose, it0 = it1, the remaining budget, the
    # hook still measured from the entry pose
    args3b = (tuple(ref2), local, valid, R1, t1, prior.R, prior.t, info, thr, kc, budget - it1)
    ref3b = pi.align_fused_plain(*args3b, it0=it1, **statics)
    got3b = pi.align_fused(*args3b, it0=it1, **statics)
    torch.cuda.synchronize()
    err3 = max(err3, check_align("B3 phase 2", got3b, ref3b))

    # what the comparison can see: the correction each instance made, the
    # prior's pull, and both exits of the loop
    need2 = ~hook1 & (budget > it1)
    t_fin = torch.where(need2[:, None], ref3b[1], t1)
    corr_t = (t_fin - entry.t).norm(dim=-1)
    noprior = pi.align_fused(*args3a[:7], torch.zeros_like(info), *args3a[8:], it0=zero, **statics)
    pull = float((noprior[1] - got3a[1]).norm(dim=-1).min())
    log(f"kernels: B3 within tolerance of plain in both phases: max |dR|,|dt| {err3:.3e}; "
        f"iterations phase 1 {it1.tolist()}, phase 2 {ref3b[2].tolist()}; hook {hook1.tolist()}; "
        f"correction |dt| {[round(float(c), 4) for c in corr_t]} m; prior pull >= {pull:.4f} m")
    if not (bool(hook1[B - 2:].all()) and bool(need2[: B - 2].all())):
        raise AssertionError("B3 check: the hook must stop the far entries and only them")
    if not (float(corr_t[: B - 2].min()) > 10 * B3_TOL["pose"] and pull > 3 * B3_TOL["pose"]):
        raise AssertionError("B3 check: corrections or the prior's pull too small for the tolerance")

    # times at these shapes (plain twins once or twice: they are slow); B3
    # per launch, as the mean of the two phases
    def both(fn):
        return lambda: (fn(*args3a, it0=zero, **statics), fn(*args3b, it0=it1, **statics))

    ms1 = cuda_ms(lambda: pc.capture_planar(*args1, **kw1), 20, 3)
    pms1 = cuda_ms(lambda: pc.capture_planar_plain(*args1, **kw1), 2)
    ms2 = cuda_ms(lambda: pc.capture_planar_reselect(*args2, **kw2), 20, 3)
    pms2 = cuda_ms(lambda: pc.capture_planar_reselect_plain(*args2, **kw2), 2)
    ms3 = cuda_ms(both(pi.align_fused), 10, 2) / 2
    pms3 = cuda_ms(both(pi.align_fused_plain), 1, 0) / 2

    # bounds from this run's inputs: bytes each input read once / each output
    # written once; B1's table input counts the distinct rows it probes
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
    b2 = bound(rows + 2 * q_bytes + planes, flops_sel)
    it_total = int(ref3a[2].sum() + ref3b[2].sum() + 2 * B)  # + each launch's quality pass
    flops3 = it_total * npad * (C * 9 + 18 + statics["gn_inner"] * 45)
    b3 = bound(2 * (B * N * 13 + planes + 2 * B * maxit * 4 + B * 16 * 4), flops3)
    b3 = (b3[0] / 2, b3[1])
    card = torch.cuda.get_device_name(0)
    for name, ms, pms, bd in (("B1", ms1, pms1, b1), ("B2", ms2, pms2, b2), ("B3", ms3, pms3, b3)):
        log(f"kernels: {name} {ms:.4f} ms (plain {pms:.3f} ms, bound {bd[0]:.4f} ms by {bd[1]}) "
            f"on {card}")
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


# ---------------------------------------------------------------------------
# phase 4: the main path — the B=8 fleet over the bench's scans
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
    for e in sorted(evs, key=dev_us, reverse=True)[:12]:
        log(f"profile:   {dev_us(e) / 1e3:8.3f} ms  x{e.count:<5d} {e.key[:90]}")
    return carry, out


def phase_main_path(dev, recs):
    """Step the fleet through the scans on the kernels; returns scans/s."""
    import torch

    from mola_lidar_odometry_tpu_torch.models.spec import spec_from_yaml
    from mola_lidar_odometry_tpu_torch.ops import se3
    from mola_lidar_odometry_tpu_torch.parallel import batch as pb
    from mola_lidar_odometry_tpu_torch.utils.config import load_yaml_file

    t0 = time.time()
    scans, traj = bench_scans(N_SCANS)
    log(f"main: simulated {N_SCANS} scans of {len(scans[0][0])} rays in {time.time() - t0:.1f} s (host)")
    cfg = load_yaml_file(os.path.join(HERE, "pipelines", "lidar3d-default.yaml"), env={})
    spec = spec_from_yaml(cfg, kf_ring_capacity=256, **SIZING)
    fstep = pb.make_fleet_step(spec)
    seq = [pb.pack_scans(spec, [s] * BATCH, [traj.stamps[k]] * BATCH, device=dev) for k, s in enumerate(scans)]
    carry = pb.init_fleet_carry(spec, BATCH, device=dev)
    torch.cuda.synchronize()

    for r in recs:
        r["wrapper"].launches = 0
    outs, secs = [], []
    for k in range(N_SCANS - 1):
        t1 = time.time()
        carry, out = fstep(carry, seq[k])
        torch.cuda.synchronize()
        secs.append(time.time() - t1)
        outs.append(out)
    carry, out = profile_step(fstep, carry, seq[-1])  # the last frame, under the profiler
    outs.append(out)
    for r in recs:
        r["launches"] = r.pop("wrapper").launches

    q = torch.stack([o.quality for o in outs]).cpu().numpy()
    nicp = torch.stack([o.n_icp_layer for o in outs]).cpu().numpy()
    nmap = torch.stack([o.n_map_layer for o in outs]).cpu().numpy()
    drops = int(torch.stack([o.map_collision_drops for o in outs]).sum())
    iters = torch.stack([o.iterations for o in outs]).cpu().numpy()
    G = lambda k: se3.Pose(torch.tensor(traj.R[k], dtype=torch.float32), torch.tensor(traj.t[k], dtype=torch.float32))  # noqa: E731
    est = se3.Pose(carry.pose_R[0].cpu(), carry.pose_t[0].cpu())
    gt_err = float(torch.linalg.norm(se3.se3_log(se3.relative(se3.relative(G(0), G(N_SCANS - 1)), est))))
    icp_cap = SIZING["layer_capacities"]["decimated_for_icp"]
    map_cap = SIZING["layer_capacities"]["decimated_for_map"]
    warm = 2  # frame 0 seeds the map, frame 1 is the first ICP on it
    sps = BATCH * len(secs[warm:]) / sum(secs[warm:])
    card = torch.cuda.get_device_name(0)
    log(f"main: per-step seconds {[round(s, 4) for s in secs]}")
    log(f"main: mean quality (frames > 0) {q[1:].mean():.4f}; iterations per frame {iters[:, 0].tolist()}; "
        f"final-pose GT error {gt_err:.4f}; icp layer max {int(nicp.max())}/{icp_cap}; "
        f"map layer max {int(nmap.max())}/{map_cap}; collision drops {drops}/{int(nmap.sum())}")
    log(f"main: {sps:.2f} scans/s over frames {warm}..{len(secs) - 1} (B={BATCH}) on {card}")
    log("main: launches " + ", ".join(f"{r['name']}={r['launches']}" for r in recs))
    failures = []
    if not q[1:].mean() > 0.9:
        failures.append(f"mean quality {q[1:].mean():.3f} <= 0.9")
    if not gt_err < 0.20:
        failures.append(f"final-pose GT error {gt_err:.3f} >= 0.20")
    if not nicp.max() < icp_cap:
        failures.append(f"decimated_for_icp saturated ({int(nicp.max())})")
    if not nmap.max() < map_cap:
        failures.append(f"decimated_for_map saturated ({int(nmap.max())})")
    if drops > 1e-3 * nmap.sum():
        failures.append(f"collision drops {drops} > 0.1% of {int(nmap.sum())}")
    failures += [f"{r['name']} never launched on the main path" for r in recs if r["launches"] <= 0]
    if failures:
        raise AssertionError("; ".join(failures))
    return sps


def main():
    import torch

    phase_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    recs = phase_kernels("cuda")
    phase_main_path("cuda", recs)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in recs]}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
