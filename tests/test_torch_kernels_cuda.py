"""The port's CUDA kernels against their plain twins on the card.

The card tests are marked ``cuda`` and skip when no CUDA device is visible (decided
inside the test).  On a machine with a GPU and nvcc:

    python -m pytest tests/test_torch_kernels_cuda.py -q -m cuda --noconftest

(``--noconftest``: tests/conftest.py configures JAX, which the GPU machine
need not have; this file imports nothing of it.)

B1/B2/B4 must equal their twins bit for bit (B2 also at its edge cases); B3 must agree within 3e-3 on R
and t, one iteration and 0.02 quality (reduction order differs), at both of
its branches (candidate planes in shared memory, and read from global memory
where a slice's planes do not fit)."""

import numpy as np
import pytest
import torch

from mola_lidar_odometry_tpu_torch.ops import pallas_capture as pc, pallas_icp as pi, pallas_match as pm, se3
from mola_lidar_odometry_tpu_torch.ops import voxel_hash as vh
from mola_lidar_odometry_tpu_torch.ops.pointcloud import PointCloud

B = 3


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return "cuda"


def _scene(dev, n=700, seed=0, b=B, K=20, slots=1 << 12, dup=False):
    """A map of ``slots`` slots holding K points per voxel (with ``dup``,
    each of 1000 points inserted twice) and queries near its surfaces."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-8, 8, (b, 4000, 3)).astype(np.float32)
    pts[:, :2000, 2] = 0.0
    if dup:
        pts[:, 2000:3000] = pts[:, 3000:4000]
    m = vh.VoxelHashMap.create(slots, K, 1.0, batch=b, device=dev)
    m, _ = vh.insert_stats(m, PointCloud.from_xyz(torch.from_numpy(pts).to(dev)))
    local = pts[:, rng.integers(0, 4000, n)] + rng.normal(0, 0.05, (b, n, 3)).astype(np.float32)
    valid = rng.random((b, n)) > 0.1
    return m, torch.from_numpy(local).to(dev), torch.from_numpy(valid).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "nbr,n,masked", [(1, 700, True), (4, 700, True), (8, 700, True), (27, 700, True), (8, 333, False), (27, 31, False)]
)
def test_capture_kernels_bit_exact(dev, nbr, n, masked):
    """B1 and B2 at every probe count, N not a multiple of 32, with and
    without a valid mask."""
    m, q, valid = _scene(dev, n=n)
    valid = valid if masked else None
    args = (m.data, m.voxel_size, m.epoch, q, nbr)
    kw = dict(K=m.K, stride=m.stride, valid=valid, return_rows=True)
    before = pc.capture_planar.launches
    got, ref = pc.capture_planar(*args, **kw), pc.capture_planar_plain(*args, **kw)
    assert pc.capture_planar.launches == before + 1
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    without_rows = pc.capture_planar(*args, **dict(kw, return_rows=False))
    assert len(without_rows) == 4 and all(torch.equal(g, r) for g, r in zip(without_rows, ref))
    moved = se3.transform(se3.se3_exp(torch.tensor([0.05, 0.0, -0.02, 0.0, 0.01, 0.0], device=dev).expand(B, 6)), q)
    args2 = (got[4], m.voxel_size, m.epoch, moved.contiguous(), q, nbr)
    kw2 = dict(K=m.K, stride=m.stride, valid=valid)
    for g, r in zip(pc.capture_planar_reselect(*args2, **kw2), pc.capture_planar_reselect_plain(*args2, **kw2)):
        assert torch.equal(g, r)


def _reselect_case(dev, case):
    """B2's arguments for one edge case, on rows B1 gathered at ``q_cap``;
    returns them with a check that the case holds what it is named for."""
    n = {"n31": 31, "n31_masked": 31, "n333": 333, "n333_masked": 333}.get(case, 700)
    K = {"w2_k32": 32, "k10": 10}.get(case, 20)
    slots = 1 if case == "w1_one_slot" else 1 << 12
    m, q, valid = _scene(dev, n=n, seed=7, K=K, slots=slots, dup=case == "duplicates")
    valid = None if case in ("n31", "n333") else valid
    rows = pc.capture_planar(m.data, m.voxel_size, m.epoch, q, 8, K=m.K, stride=m.stride, valid=valid,
                             return_rows=True)[4]
    if case == "across_voxel":
        live = (q + torch.tensor([0.6, -0.45, 0.3], device=dev)).contiguous()
    else:
        live = se3.transform(se3.se3_exp(torch.tensor([0.05, 0.0, -0.02, 0.0, 0.01, 0.0], device=dev).expand(B, 6)), q)
    epoch = m.epoch + torch.tensor([0, 1, 0], dtype=torch.int32, device=dev) if case == "stale_epoch" else m.epoch
    args = (rows, m.voxel_size, epoch, live.contiguous(), q, 8)
    kw = dict(K=m.K, stride=m.stride, valid=valid)

    def holds(planes):
        cx, cy, cz, cm = planes
        top1, top2 = (slice(0, 8), slice(8, 16))
        if case in ("w2_k32", "k10"):
            return m.stride == (64 if K == 32 else 32) and bool(cm.any())
        if case == "w1_one_slot":
            return m.stride == 128 and bool(cm.any())
        if case == "stale_epoch":  # instance 1: no way matches, nothing live
            return not bool(cm[1].any()) and bool(cm[0].any())
        if case == "duplicates":  # both picks on equal words of one voxel
            same = (cx[:, top1] == cx[:, top2]) & (cy[:, top1] == cy[:, top2]) & (cz[:, top1] == cz[:, top2])
            return bool((same & (cm[:, top1] > 0) & (cm[:, top2] > 0)).any())
        if case == "across_voxel":
            return bool((torch.floor(live) != torch.floor(q)).any(dim=-1).float().mean() > 0.5)
        return cx.shape[-1] == (128 if n == 31 else 512) and bool(cm.any())

    return args, kw, holds


@pytest.mark.cuda
@pytest.mark.parametrize(
    "case",
    ["w2_k32", "k10", "w1_one_slot", "stale_epoch", "duplicates", "across_voxel", "n31", "n31_masked", "n333",
     "n333_masked"],
)
def test_reselect_kernel_edge_cases(dev, case):
    """B2 against its twin, bit for bit: 2 ways of 64 words (K = 32), K = 10,
    one way of 128 words, a stale epoch (way 0 the fallback), duplicate
    points (d2 ties, the lowest k first), live queries in other voxels than
    the capture's, N = 31 and 333 with and without a mask."""
    args, kw, holds = _reselect_case(dev, case)
    before = pc.capture_planar_reselect.launches
    got = pc.capture_planar_reselect(*args, **kw)
    assert pc.capture_planar_reselect.launches == before + 1
    ref = pc.capture_planar_reselect_plain(*args, **kw)
    assert all(torch.equal(g, r) for g, r in zip(got, ref))
    assert holds(ref)


def _align_close(got, ref):
    assert float((got[0] - ref[0]).abs().max()) < 3e-3
    assert float((got[1] - ref[1]).abs().max()) < 3e-3
    assert int((got[2] - ref[2]).abs().max()) <= 1
    assert float((got[5] - ref[5]).abs().max()) < 0.02
    assert torch.equal(got[3], ref[3]) and torch.equal(got[4], ref[4])


@pytest.mark.cuda
def test_align_kernel_matches_plain(dev):
    """Both phases of one fused align: entry poses 6-25 cm off the answer
    (the last far enough for the twist hook), a prior that pulls, phase 2
    resuming from phase 1's iteration count with the entry pose as hook
    reference."""
    m, q, valid = _scene(dev, seed=1)
    entry = se3.se3_exp(torch.tensor(
        [[0.06, -0.03, 0.0, 0.0, 0.0, 0.004], [0.1, 0.02, 0.01, 0.002, 0.0, -0.005],
         [0.25, 0.0, 0.0, 0.0, 0.0, 0.0]], device=dev))
    prior = se3.se3_exp(torch.tensor([0.03, 0.02, 0.0, 0.0, 0.0, 0.002], device=dev).expand(B, 6))
    info = torch.diag_embed(torch.tensor([500.0] * 3 + [2e5] * 3, device=dev).expand(B, 6)).contiguous()
    maxit = 60
    ann = torch.clamp(2.0 - 1.5 * torch.arange(maxit, device=dev) / 10, min=1.0).expand(B, maxit)
    thr, kc = (2 * ann).contiguous(), (0.5 * ann).contiguous()
    budget = torch.full((B,), maxit, dtype=torch.int32, device=dev)
    kw = dict(min_abs_step_trans=1e-4, min_abs_step_rot=5e-5, hook_min_trans=0.15, hook_min_rot=0.0131,
              hook_ref_R=entry.R, hook_ref_t=entry.t)
    q0 = se3.transform(entry, q).contiguous()
    cx, cy, cz, cm, rows = pc.capture_planar(m.data, m.voxel_size, m.epoch, q0, 8, K=m.K, stride=m.stride,
                                             valid=valid, return_rows=True)
    zero = torch.zeros((B,), dtype=torch.int32, device=dev)
    args1 = ((cx, cy, cz, cm), q, valid, entry.R, entry.t, prior.R, prior.t, info, thr, kc,
             torch.clamp(budget, max=8))
    ref1 = pi.align_fused_plain(*args1, it0=zero, **kw)
    _align_close(pi.align_fused(*args1, it0=zero, **kw), ref1)
    assert ref1[3].tolist() == [False, False, True]
    planar2 = pc.capture_planar_reselect(rows, m.voxel_size, m.epoch, se3.transform(se3.Pose(ref1[0], ref1[1]), q),
                                         q0, 8, K=m.K, stride=m.stride, valid=valid)
    args2 = (planar2, q, valid, ref1[0], ref1[1], prior.R, prior.t, info, thr, kc, budget - ref1[2])
    _align_close(pi.align_fused(*args2, it0=ref1[2], **kw), pi.align_fused_plain(*args2, it0=ref1[2], **kw))


def _align_setup(dev, b, n, nbr, seed, maxit=60):
    """A capture at entry poses 4-12 cm off the answer and the align's other
    inputs (a prior that pulls, annealed thresholds)."""
    m, q, valid = _scene(dev, n=n, seed=seed, b=b)
    xi = torch.tensor([[0.04 + 0.01 * (k % 8), -0.03, 0.01, 0.002, 0.0, 0.004] for k in range(b)], device=dev)
    entry = se3.se3_exp(xi)
    prior = se3.se3_exp(torch.tensor([0.03, 0.02, 0.0, 0.0, 0.0, 0.002], device=dev).expand(b, 6))
    info = torch.diag_embed(torch.tensor([500.0] * 3 + [2e5] * 3, device=dev).expand(b, 6)).contiguous()
    ann = torch.clamp(2.0 - 1.5 * torch.arange(maxit, device=dev) / 10, min=1.0).expand(b, maxit)
    thr, kc = (2 * ann).contiguous(), (0.5 * ann).contiguous()
    planar = pc.capture_planar(m.data, m.voxel_size, m.epoch, se3.transform(entry, q).contiguous(), nbr,
                               K=m.K, stride=m.stride, valid=valid)
    kw = dict(min_abs_step_trans=1e-4, min_abs_step_rot=5e-5, hook_min_trans=0.5, hook_min_rot=0.1,
              hook_ref_R=entry.R, hook_ref_t=entry.t)
    return (planar, q, valid, entry.R, entry.t, prior.R, prior.t, info, thr, kc), kw


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,nbr", [(1, 3000, 8), (8, 3000, 8), (8, 3000, 1), (8, 3000, 4), (2, 16000, 8)])
def test_align_kernel_shapes(dev, b, n, nbr):
    """B3 at B=1 and 8, C = 2, 8 and 16, and at an npad whose slice's planes
    do not fit in shared memory (the global-memory branch, 2 points per
    thread)."""
    args, kw = _align_setup(dev, b, n, nbr, seed=3)
    npad, C = args[0][0].shape[2], args[0][0].shape[1]
    geo = pi.align_geometry(npad, C)
    assert C == 2 * nbr and geo.planes_in_smem == (n < 4000)
    budget = torch.full((b,), 60, dtype=torch.int32, device=dev)
    before = pi.align_fused.launches
    got, ref = pi.align_fused(*args, budget, **kw), pi.align_fused_plain(*args, budget, **kw)
    assert pi.align_fused.launches == before + 1
    _align_close(got, ref)
    assert bool((ref[2] > 1).all()) and bool(ref[4].all())  # every instance iterated and converged


@pytest.mark.cuda
def test_align_kernel_budget_resume_and_no_pairs(dev):
    """Per instance: an exhausted budget (it0 + budget reached before
    convergence), a zero budget, a resumed count (it0 > 0), and an instance
    with no valid point and so no pairs (the prior alone moves it)."""
    args, kw = _align_setup(dev, 5, 700, 8, seed=4)
    valid = args[2].clone()
    valid[4] = False
    args = args[:2] + (valid,) + args[3:]
    it0 = torch.tensor([0, 0, 0, 7, 0], dtype=torch.int32, device=dev)
    budget = torch.tensor([60, 2, 0, 50, 60], dtype=torch.int32, device=dev)
    got = pi.align_fused(*args, budget, it0=it0, **kw)
    ref = pi.align_fused_plain(*args, budget, it0=it0, **kw)
    _align_close(got, ref)
    assert ref[2].tolist()[1:3] == [2, 0] and not bool(ref[4][1]) and float(ref[5][4]) == 0.0
    assert float((ref[1][4] - args[4][4]).norm()) > 1e-3  # the prior pulled the pair-less instance


@pytest.mark.cuda
def test_align_kernel_refused_launch_raises(dev):
    """A cluster the card cannot schedule, or more shared memory than a CTA
    may have, raises instead of running anything else; the refusal leaves no
    error behind, so a valid launch right after it runs and agrees."""
    args, kw = _align_setup(dev, 2, 700, 8, seed=5)
    budget = torch.full((2,), 10, dtype=torch.int32, device=dev)
    geo = pi.align_geometry(args[0][0].shape[2], args[0][0].shape[1])
    ref = pi.align_fused_plain(*args, budget, **kw)
    for bad in (geo._replace(cluster=32), geo._replace(smem_bytes=300 * 1024)):
        launch, _ = pi.align_launcher(bad, *args, budget, **kw)
        with pytest.raises(RuntimeError, match="align_kernel"):
            launch()
        _align_close(pi.align_fused(*args, budget, **kw), ref)


@pytest.mark.cuda
@pytest.mark.parametrize("nbr,n", [(8, 700), (27, 700), (27, 333), (1, 31)])
def test_nn_select_kernel_bit_exact(dev, nbr, n):
    """B4 on real captures (C = 2, 16 and 54; N not a multiple of 32),
    queries moved off the capture pose so some have no candidate, plus exact
    ties, a masked candidate 0 and rows with no candidate at all."""
    m, q, valid = _scene(dev, n=n, seed=2)
    planar = pm.to_planar(vh.capture(m, q, nbr, per_voxel_nn=True))
    moved = (q * 1.2 + 0.3).contiguous()
    before = pm.nn_select.launches
    for queries in (q, moved):
        got, ref = pm.nn_select(planar, queries), pm.nn_select_plain(planar, queries)
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    assert pm.nn_select.launches == before + 2
    rng = np.random.default_rng(5)
    C = planar.mask.shape[-1]
    cand = rng.integers(-6, 7, (B, n, C, 3)).astype(np.float32)
    cand[cand == 0] = -0.0
    mask = rng.random((B, n, C)) > 0.3
    cand[:, :, C - 1] = cand[:, :, 0]  # ties between the first and the last candidate
    mask[:, : n // 3] = False  # no candidate at all
    mask[:, n // 3 : n // 2, 0] = False  # a masked candidate 0
    syn = pm.to_planar(vh.CandSet(torch.from_numpy(cand).to(dev), torch.from_numpy(mask).to(dev)))
    sq = torch.from_numpy(rng.integers(-3, 4, (B, n, 3)).astype(np.float32)).to(dev)
    got, ref = pm.nn_select(syn, sq), pm.nn_select_plain(syn, sq)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    assert bool((got[1][:, : n // 3] == 3.4e38).all()) and not bool(torch.signbit(got[0][got[0] == 0]).any())
    with pytest.raises(ValueError):
        pm.nn_select(syn, sq.double())


def test_cpu_tensors_take_the_plain_twin():
    """On the CPU the wrappers (B1, B2, B3, B4) run their twins and count no launch."""
    m, q, valid = _scene("cpu")
    before = pc.capture_planar.launches
    out = pc.capture_planar(m.data, m.voxel_size, m.epoch, q, 8, K=m.K, stride=m.stride, valid=valid)
    ref = pc.capture_planar_plain(m.data, m.voxel_size, m.epoch, q, 8, K=m.K, stride=m.stride, valid=valid)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    assert pc.capture_planar.launches == before
    args, kw, _ = _reselect_case("cpu", "n333_masked")
    before = pc.capture_planar_reselect.launches
    out, ref = pc.capture_planar_reselect(*args, **kw), pc.capture_planar_reselect_plain(*args, **kw)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    assert pc.capture_planar_reselect.launches == before
    before = pi.align_fused.launches
    args, kw = _align_setup("cpu", 2, 300, 8, seed=6, maxit=10)
    budget = torch.full((2,), 10, dtype=torch.int32)
    got, ref = pi.align_fused(*args, budget, **kw), pi.align_fused_plain(*args, budget, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert pi.align_fused.launches == before
    planar = pm.to_planar(vh.capture(m, q, 8, per_voxel_nn=True))
    before = pm.nn_select.launches
    got, ref = pm.nn_select(planar, q), pm.nn_select_plain(planar, q)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    assert pm.nn_select.launches == before
