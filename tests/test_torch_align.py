"""Port parity: the plain twin of kernel B3 (fused align) and the port's
fused ``icp.align`` against the JAX package's ``pallas_icp.align_fused`` and
``icp.align`` (Pallas kernels in interpret mode on the CPU), on the scene of
tests/test_pallas_icp.py.

Tolerance: the JAX package's own kernel-vs-XLA gate (3e-3 on R and t, one
iteration, 0.02 quality) — the two sum their Gram moments in different
orders, so float32 results differ in the last bits and may converge one
iteration apart."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mola_lidar_odometry_tpu.ops import icp as jicp, pallas_icp as jpi, se3 as jse3, voxel_hash as jvh
from mola_lidar_odometry_tpu.ops.pointcloud import PointCloud as JPC
from mola_lidar_odometry_tpu.ops.se3 import Pose as JPose
from mola_lidar_odometry_tpu.ops.solver import PosePrior as JPrior
from mola_lidar_odometry_tpu.utils.expr import Expr as JExpr
from mola_lidar_odometry_tpu_torch.ops import icp as ticp, pallas_capture as tpc, pallas_icp as tpi
from mola_lidar_odometry_tpu_torch.ops import voxel_hash as tvh
from mola_lidar_odometry_tpu_torch.ops.pointcloud import PointCloud as TPC
from mola_lidar_odometry_tpu_torch.ops.se3 import Pose as TPose
from mola_lidar_odometry_tpu_torch.ops.solver import PosePrior as TPrior
from mola_lidar_odometry_tpu_torch.utils.expr import Expr as TExpr

B = 2
THR = "2.0*max(1.0, 2.0-(1.5)*ICP_ITERATION/10)"
KC = "0.5*max(1.0, 2.0-(1.5)*ICP_ITERATION/10)"


def _world(seed=0, n=4096):
    rng = np.random.default_rng(seed)
    g = rng.uniform(-20, 20, (n, 2)).astype(np.float32)
    floor = np.stack([g[:, 0], g[:, 1], np.zeros(n, np.float32)], 1)
    w1 = np.stack([g[: n // 2, 0], np.full(n // 2, 8.0, np.float32), rng.uniform(0, 4, n // 2).astype(np.float32)], 1)
    w2 = np.stack([np.full(n // 2, -6.0, np.float32), g[n // 2 :, 1], rng.uniform(0, 4, n // 2).astype(np.float32)], 1)
    return np.concatenate([floor, w1, w2]).astype(np.float32)


@pytest.fixture(scope="module")
def scene():
    pts = _world()
    jm = jvh.insert(jvh.VoxelHashMap.create(1 << 14, 8, 0.8), JPC.from_xyz(jnp.asarray(pts)))
    tm = tvh.VoxelHashMap.create(1 << 14, 8, 0.8, batch=B, device="cpu")
    tm, _ = tvh.insert_stats(tm, TPC.from_xyz(torch.from_numpy(np.stack([pts] * B))))
    np.testing.assert_array_equal(tm.data[0].numpy(), np.asarray(jm.data))
    rng = np.random.default_rng(1)
    sel = rng.choice(len(pts), 1024, replace=False)
    true_pose = JPose(
        jse3.so3_exp(jnp.asarray([0.004, -0.006, 0.02], jnp.float32)),
        jnp.asarray([0.15, -0.08, 0.02], jnp.float32),
    )
    world_q = jnp.asarray(pts[sel] + rng.normal(0, 0.01, (1024, 3)).astype(np.float32))
    local = np.asarray(jse3.transform(JPose(true_pose.R.T, -true_pose.R.T @ true_pose.t), world_q))
    valid = np.ones((1024,), bool)
    valid[::17] = False
    init_t = np.array([[0.0, 0.0, 0.0], [0.05, 0.0, 0.0]], np.float32)
    info = np.zeros((B, 6, 6), np.float32)
    info[1] = np.diag([4.0, 4.0, 4.0, 9.0, 9.0, 9.0])  # instance 1 carries a prior
    prior_t = np.array([[0.0, 0.0, 0.0], [0.12, -0.05, 0.0]], np.float32)
    return jm, tm, local, valid, init_t, info, prior_t


def _close(got, ref_R, ref_t, ref_it, ref_q, b):
    np.testing.assert_allclose(got[0][b].numpy(), np.asarray(ref_R), atol=3e-3)
    np.testing.assert_allclose(got[1][b].numpy(), np.asarray(ref_t), atol=3e-3)
    assert abs(int(got[2][b]) - int(ref_it)) <= 1
    assert abs(float(got[5][b]) - float(ref_q)) < 0.02


@pytest.mark.parametrize("resume", [False, True])
def test_align_fused_plain_matches_pallas(scene, resume):
    """Identical planar candidates into both kernels; ``resume`` runs the
    phase-2 shape: a non-zero it0, an entry pose away from the hook
    reference, and a remaining budget."""
    jm, tm, local, valid, init_t, info, prior_t = scene
    eye = np.broadcast_to(np.eye(3, dtype=np.float32), (B, 3, 3)).copy()
    entry_t = init_t + (np.float32(0.03) if resume else np.float32(0.0))
    q = local[None] + entry_t[:, None, :]
    planar = tpc.capture_planar(
        tm.data, tm.voxel_size, tm.epoch, torch.from_numpy(q), 8, K=8, stride=32,
        valid=torch.from_numpy(np.stack([valid] * B)),
    )
    maxit = 40
    it_ax = np.arange(maxit, dtype=np.float32)
    thr = np.stack([np.asarray(JExpr(THR)({"ICP_ITERATION": jnp.asarray(it_ax)}))] * B)
    kc = np.stack([np.asarray(JExpr(KC)({"ICP_ITERATION": jnp.asarray(it_ax)}))] * B)
    it0 = np.array([3, 5] if resume else [0, 0], np.int32)
    budget = np.array([30, 20], np.int32)
    statics = dict(min_abs_step_trans=1e-4, min_abs_step_rot=5e-5, hook_min_trans=0.5, hook_min_rot=0.2)
    T = torch.from_numpy
    got = tpi.align_fused_plain(
        planar, T(np.stack([local] * B)), T(np.stack([valid] * B)), T(eye), T(entry_t), T(eye),
        T(prior_t), T(info), T(thr), T(kc), T(budget), it0=T(it0), hook_ref_R=T(eye),
        hook_ref_t=T(init_t), **statics,
    )
    for b in range(B):
        R, t, it, hook, conv, qual = jpi.align_fused(
            None, None, jnp.asarray(local), jnp.asarray(valid), jnp.eye(3), jnp.asarray(entry_t[b]),
            jnp.eye(3), jnp.asarray(prior_t[b]), jnp.asarray(info[b]), jnp.asarray(thr[b]),
            jnp.asarray(kc[b]), jnp.int32(budget[b]), maxit_static=maxit, interpret=True,
            it0=jnp.int32(it0[b]), hook_ref_R=jnp.eye(3), hook_ref_t=jnp.asarray(init_t[b]),
            planar=tuple(jnp.asarray(x[b].numpy()) for x in planar), **statics,
        )
        _close(got, R, t, it, qual, b)
        assert bool(got[3][b]) == bool(hook) and bool(got[4][b]) == bool(conv)
    assert float(got[5].min()) > 0.9


def _cfgs(max_iterations):
    kw = dict(max_iterations=max_iterations, hook_min_trans=0.5, hook_min_rot=0.2, nn_neighbors=8)
    jcfg = jicp.IcpConfig(
        matchers=(jicp.MatcherCfg(threshold=JExpr(THR), local_layer="icp"),), kernel_param=JExpr(KC),
        per_voxel_nn=True, use_pallas=True, **kw,
    )
    tcfg = ticp.IcpConfig(
        matchers=(ticp.MatcherCfg(threshold=TExpr(THR), local_layer="icp"),), kernel_param=TExpr(KC), **kw
    )
    return jcfg, tcfg


@pytest.mark.parametrize("max_iterations", [ticp._FUSED_REFRESH_AT, 60])
def test_icp_align_matches_jax(scene, monkeypatch, max_iterations):
    """The whole fused align: single phase (budget at the refresh point) and
    two phases (capture, align, reselect, align)."""
    monkeypatch.setenv("MOLA_TPU_PALLAS_CAPTURE", "1")  # the JAX package's TPU path
    jm, tm, local, valid, init_t, info, prior_t = scene
    jcfg, tcfg = _cfgs(max_iterations)
    eye = np.broadcast_to(np.eye(3, dtype=np.float32), (B, 3, 3)).copy()
    T = torch.from_numpy
    res = ticp.align(
        {"localmap": tm}, {"icp": (T(np.stack([local] * B)), T(np.stack([valid] * B)))},
        TPose(T(eye), T(init_t)), TPrior(TPose(T(eye), T(prior_t)), T(info)), tcfg, {},
    )
    got = (res.pose.R, res.pose.t, res.iterations, res.hook_stop, res.converged, res.quality)
    for b in range(B):
        ref = jicp.align(
            {"localmap": jm}, {"icp": (jnp.asarray(local), jnp.asarray(valid))},
            JPose(jnp.eye(3), jnp.asarray(init_t[b])),
            JPrior(JPose(jnp.eye(3), jnp.asarray(prior_t[b])), jnp.asarray(info[b])), jcfg, {},
        )
        _close(got, ref.pose.R, ref.pose.t, ref.iterations, ref.quality, b)
        assert bool(res.hook_stop[b]) == bool(ref.hook_stop)


def test_non_fused_config_raises(scene):
    """A configuration outside the fused path no longer raises: it runs the
    generic loop, here with a Horn stage and with a single point-to-plane
    matcher (a plane fitted per query to its candidates), which ends where
    the JAX package's does.  What still raises is the occupancy map class,
    naming its ROADMAP item."""
    from mola_lidar_odometry_tpu_torch.ops import maps as tmaps

    jm, tm, local, valid, *_ = scene
    jcfg, tcfg = _cfgs(30)
    T = torch.from_numpy
    args = (
        {"localmap": tm}, {"icp": (T(np.stack([local] * B)), T(np.stack([valid] * B)))},
        TPose.identity((B,), device="cpu"), TPrior.none(B, device="cpu"),
    )
    res = ticp.align(*args, dataclasses.replace(tcfg, horn=ticp.HornCfg()), {})
    assert float(res.quality.min()) > 0.9 and not res.hook_stop.any()
    p2pl = dataclasses.replace(tcfg, matchers=(ticp.MatcherCfg(kind="point2plane", local_layer="icp", threshold=TExpr(THR)),))
    res = ticp.align(*args, p2pl, {})
    jp2pl = dataclasses.replace(jcfg, use_pallas=False, matchers=(
        jicp.MatcherCfg(kind="point2plane", local_layer="icp", threshold=JExpr(THR)),))
    ref = jax.jit(lambda m, q, v: jicp.align({"localmap": m}, {"icp": (q, v)}, JPose(jnp.eye(3), jnp.zeros(3)),
                                             JPrior.none(), jp2pl, {}))(jm, jnp.asarray(local), jnp.asarray(valid))
    for b in range(B):
        np.testing.assert_allclose(res.pose.R[b].numpy(), np.asarray(ref.pose.R), atol=3e-3)
        np.testing.assert_allclose(res.pose.t[b].numpy(), np.asarray(ref.pose.t), atol=3e-3)
        assert abs(int(res.iterations[b]) - int(ref.iterations)) <= 1
        assert abs(float(res.quality[b]) - float(ref.quality)) < 0.02
    assert float(res.quality.min()) > 0.5
    with pytest.raises(NotImplementedError, match="other pipeline families"):
        tmaps.MapLayerDef(map_class="CVoxelMap").create(1.0, B, "cpu")
