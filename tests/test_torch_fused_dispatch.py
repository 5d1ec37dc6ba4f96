"""Port parity for the rest of the JAX package's ICP dispatch: the fused
align over the plain per-voxel capture (the JAX package's path for maps
whose slot is wider than one 128-lane row, 127-254 points per voxel, and
for ``MOLA_TPU_PALLAS_CAPTURE=0``) with its fresh-capture refresh, the
fused path's switches (``MOLA_TPU_PHASE1_NEIGHBORS``,
``MOLA_TPU_REFRESH_RESELECT``, ``MOLA_TPU_REFRESH_NEIGHBORS``,
``MOLA_TPU_FUSED_REFRESH``) and ``use_pallas`` off (``MOLA_TPU_PALLAS=0``:
the generic loop over the per-voxel view).

Each item aligns B = 2 instances (one with a prior) of a few hundred ICP
points against a map of a few hundred voxels with the port's
``ops/icp.py::align`` (CPU tensors: every kernel's plain twin) and, per
instance, with the JAX package's ``align`` called eagerly under the
matching switches (its Pallas kernels in interpret mode).  A budget of 12
iterations lets the refresh at iteration 8 fire.  Held: pose within 1e-5,
quality within 1e-6, iterations and the hook and convergence flags equal.
The last item also holds ``spec_from_yaml``'s nine ICP overrides on both
ICP blocks and the CLI's six new flags against their variables.

Five items on purpose (ROADMAP's test budget: xdist's ``--dist loadfile``
queues files by item count)."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mola_lidar_odometry_tpu.ops import icp as jicp, se3 as jse3, voxel_hash as jvh
from mola_lidar_odometry_tpu.ops.se3 import Pose as JPose
from mola_lidar_odometry_tpu.ops.solver import PosePrior as JPrior
from mola_lidar_odometry_tpu.utils.expr import Expr as JExpr
from mola_lidar_odometry_tpu_torch.ops import icp as ticp, pallas_capture as tpc, pallas_icp as tpi
from mola_lidar_odometry_tpu_torch.ops import pallas_match as tpm, voxel_hash as tvh
from mola_lidar_odometry_tpu_torch.ops.pointcloud import PointCloud as TPC
from mola_lidar_odometry_tpu_torch.ops.se3 import Pose as TPose
from mola_lidar_odometry_tpu_torch.ops.solver import PosePrior as TPrior
from mola_lidar_odometry_tpu_torch.utils.expr import Expr as TExpr

HERE = os.path.dirname(os.path.abspath(__file__))
B = 2
N = 400
MAXIT = 12  # past ticp._FUSED_REFRESH_AT, so the refresh fires
THR = "2.0*max(1.0, 2.0-(1.5)*ICP_ITERATION/10)"
KC = "0.5*max(1.0, 2.0-(1.5)*ICP_ITERATION/10)"
SWITCHES = ("MOLA_TPU_PALLAS", "MOLA_TPU_PER_VOXEL_NN", "MOLA_TPU_PALLAS_CAPTURE", "MOLA_TPU_NN_NEIGHBORS",
            "MOLA_TPU_ICP_ANDERSON", "MOLA_TPU_PHASE1_NEIGHBORS", "MOLA_TPU_REFRESH_RESELECT",
            "MOLA_TPU_REFRESH_NEIGHBORS", "MOLA_TPU_FUSED_REFRESH")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _world(rng, n=2400):
    """A 12 x 12 m floor and two walls: ~250 voxels of 1 m."""
    g = rng.uniform(-6, 6, (n, 2)).astype(np.float32)
    floor = np.stack([g[:, 0], g[:, 1], np.zeros(n, np.float32)], 1)
    w1 = np.stack([g[: n // 2, 0], np.full(n // 2, 4.2, np.float32), rng.uniform(0, 3, n // 2).astype(np.float32)], 1)
    w2 = np.stack([np.full(n // 2, -3.7, np.float32), g[n // 2 :, 1], rng.uniform(0, 3, n // 2).astype(np.float32)], 1)
    return np.concatenate([floor, w1, w2]).astype(np.float32)


def _scene(K):
    """The map of one world at ``K`` points per voxel (four inserts, each
    moved by up to 3 cm, so deep voxels fill past 126 points), both
    packages holding the same table; the ICP points seen from a true pose,
    two entry poses 5 and 9 cm off it, instance 1 with a prior."""
    rng = np.random.default_rng(K)
    pts = _world(rng)
    tm = tvh.VoxelHashMap.create(1 << 12, K, 1.0, batch=B, device="cpu")
    for _ in range(4):
        moved = pts + rng.uniform(-0.03, 0.03, pts.shape).astype(np.float32)
        tm, _ = tvh.insert_stats(tm, TPC.from_xyz(torch.from_numpy(np.stack([moved] * B))))
    jm = jvh.VoxelHashMap.create(1 << 12, K, 1.0)._replace(data=jnp.asarray(tm.data[0].numpy()))
    assert jm.stride == tm.stride
    true_pose = JPose(jse3.so3_exp(jnp.asarray([0.004, -0.006, 0.02], jnp.float32)),
                      jnp.asarray([0.15, -0.08, 0.02], jnp.float32))
    sel = rng.choice(len(pts), N, replace=False)
    world_q = jnp.asarray(pts[sel] + rng.normal(0, 0.01, (N, 3)).astype(np.float32))
    local = np.asarray(jse3.transform(JPose(true_pose.R.T, -true_pose.R.T @ true_pose.t), world_q))
    valid = np.ones((N,), bool)
    valid[::17] = False
    off = np.array([[0.05, 0.0, 0.0, 0, 0, 0.002], [-0.06, 0.07, 0.01, 0.002, 0, -0.004]], np.float32)
    entry = [jse3.compose(jse3.se3_exp(jnp.asarray(x)), true_pose) for x in off]
    info = np.zeros((B, 6, 6), np.float32)
    info[1] = np.diag([4.0, 4.0, 4.0, 9.0, 9.0, 9.0])
    prior_t = np.stack([np.asarray(true_pose.t), np.asarray(true_pose.t) + np.float32(0.02)])
    return dict(tm=tm, jm=jm, local=local, valid=valid, entry_R=np.stack([np.asarray(P.R) for P in entry]),
                entry_t=np.stack([np.asarray(P.t) for P in entry]), info=info, prior_R=np.asarray(true_pose.R),
                prior_t=prior_t)


@pytest.fixture(scope="module")
def k20():
    return _scene(20)


def _cfgs(**port_knobs):
    """(the JAX package's ICP block with ``use_pallas`` and
    ``per_voxel_nn`` on, the port's with ``port_knobs``)."""
    kw = dict(max_iterations=MAXIT, hook_min_trans=0.5, hook_min_rot=0.2, nn_neighbors=8)
    jcfg = jicp.IcpConfig(matchers=(jicp.MatcherCfg(threshold=JExpr(THR), local_layer="icp"),),
                          kernel_param=JExpr(KC), per_voxel_nn=True, use_pallas=True, **kw)
    tcfg = ticp.IcpConfig(matchers=(ticp.MatcherCfg(threshold=TExpr(THR), local_layer="icp"),),
                          kernel_param=TExpr(KC), **kw, **port_knobs)
    return jcfg, tcfg


def _align_both(s, monkeypatch, jenv, port_knobs, jcfg_edit=None):
    """The port's align of both instances against the JAX package's per
    instance under ``jenv`` (its switches are read when it traces); returns
    the port's result and the iterations of each instance."""
    for k in SWITCHES:
        monkeypatch.delenv(k, raising=False)
    for k, v in jenv.items():
        monkeypatch.setenv(k, v)
    jcfg, tcfg = _cfgs(**port_knobs)
    if jcfg_edit:
        jcfg = dataclasses.replace(jcfg, **jcfg_edit)
    T = torch.from_numpy
    eye = np.stack([s["prior_R"]] * B)
    res = ticp.align({"localmap": s["tm"]}, {"icp": (T(np.stack([s["local"]] * B)), T(np.stack([s["valid"]] * B)))},
                     TPose(T(s["entry_R"]), T(s["entry_t"])), TPrior(TPose(T(eye), T(s["prior_t"])), T(s["info"])),
                     tcfg, {})
    its = []
    for b in range(B):
        ref = jicp.align(
            {"localmap": s["jm"]}, {"icp": (jnp.asarray(s["local"]), jnp.asarray(s["valid"]))},
            JPose(jnp.asarray(s["entry_R"][b]), jnp.asarray(s["entry_t"][b])),
            JPrior(JPose(jnp.asarray(s["prior_R"]), jnp.asarray(s["prior_t"][b])), jnp.asarray(s["info"][b])),
            jcfg, {},
        )
        np.testing.assert_allclose(res.pose.R[b].numpy(), np.asarray(ref.pose.R), atol=1e-5, err_msg=f"R[{b}]")
        np.testing.assert_allclose(res.pose.t[b].numpy(), np.asarray(ref.pose.t), atol=1e-5, err_msg=f"t[{b}]")
        assert int(res.iterations[b]) == int(ref.iterations), (b, res.iterations, ref.iterations)
        assert abs(float(res.quality[b]) - float(ref.quality)) <= 1e-6, (b, res.quality, ref.quality)
        assert bool(res.hook_stop[b]) == bool(ref.hook_stop) and bool(res.converged[b]) == bool(ref.converged)
        its.append(int(ref.iterations))
    assert float(res.quality.min()) > 0.8
    return res, its


class _Calls:
    """Counts the calls of the fused path's captures and of kernel B3's
    wrapper (CPU tensors: the plain twins run under them)."""

    def __init__(self, monkeypatch):
        self.n = dict(b1=[], b2=[], plain=[], b3=[], b4=0)
        for mod, name, key in ((tpc, "capture_planar", "b1"), (tpc, "capture_planar_reselect", "b2"),
                               (tvh, "capture", "plain"), (tpi, "align_fused", "b3")):
            monkeypatch.setattr(mod, name, self._wrap(getattr(mod, name), key))
        select = tpm.nn_select

        def counted(*a, **k):
            self.n["b4"] += 1
            return select(*a, **k)

        monkeypatch.setattr(tpm, "nn_select", counted)

    def _wrap(self, fn, key):
        def call(*a, **k):
            if key == "b3":
                planar = a[0]
                self.n[key].append(planar.pts.shape[2] if isinstance(planar, tvh.CandSet) else planar[0].shape[1])
            else:  # the probes of this capture
                self.n[key].append(a[{"b1": 4, "b2": 5, "plain": 2}[key]])
            return fn(*a, **k)

        return call


def test_deep_voxels_take_the_fused_align_on_the_plain_capture(monkeypatch):
    """K = 130 (a 256-lane slot): the port's defaults take the fused align,
    captured by the plain per-voxel capture (C = 16, one transpose into
    B3's planes) and refreshed by a fresh 4-probe capture (C = 8), against
    the JAX package with ``use_pallas`` and ``per_voxel_nn`` on and
    ``MOLA_TPU_PALLAS_CAPTURE`` unset.  B3's launch shape holds the
    refresh's, phase 1's and a 27-probe run's candidates."""
    s = _scene(130)
    assert (s["tm"].K, s["tm"].stride) == (130, 256) and int(s["tm"].count().max()) > 126
    calls = _Calls(monkeypatch)
    _, its = _align_both(s, monkeypatch, {}, {})
    assert calls.n == dict(b1=[], b2=[], plain=[8, 4], b3=[16, 8], b4=0), calls.n
    assert max(its) > ticp._FUSED_REFRESH_AT
    planes = tpi.candset_planes(tvh.capture(s["tm"], torch.from_numpy(np.stack([s["local"]] * B)), 8, True))
    assert [tuple(p.shape) for p in planes] == [(B, 16, 512)] * 4
    for C in (8, 16, 54):  # the refresh, phase 1, 27 probes (2 * nn_neighbors <= 64)
        geo = tpi.align_geometry(3072, C)
        assert geo.planes_in_smem and geo.smem_bytes == 16 * C * geo.slice


def test_capture_off_with_an_8_probe_refresh(k20, monkeypatch):
    """K = 20 with ``capture_kernel=False, refresh_neighbors=8`` against
    ``MOLA_TPU_PALLAS_CAPTURE=0 MOLA_TPU_REFRESH_NEIGHBORS=8``."""
    calls = _Calls(monkeypatch)
    _align_both(k20, monkeypatch, {"MOLA_TPU_PALLAS_CAPTURE": "0", "MOLA_TPU_REFRESH_NEIGHBORS": "8"},
                dict(capture_kernel=False, refresh_neighbors=8))
    assert calls.n == dict(b1=[], b2=[], plain=[8, 8], b3=[16, 16], b4=0), calls.n


def test_phase1_four_probes_with_the_reselect(k20, monkeypatch):
    """``phase1_neighbors=4``: kernel B1's twin at 4 probes with its rows,
    B2's twin re-ranking them, against ``MOLA_TPU_PALLAS_CAPTURE=1
    MOLA_TPU_PHASE1_NEIGHBORS=4`` (B1 and B2 in interpret mode)."""
    calls = _Calls(monkeypatch)
    _align_both(k20, monkeypatch, {"MOLA_TPU_PALLAS_CAPTURE": "1", "MOLA_TPU_PHASE1_NEIGHBORS": "4"},
                dict(phase1_neighbors=4))
    assert calls.n == dict(b1=[4], b2=[4], plain=[], b3=[8, 8], b4=0), calls.n


def test_fresh_refresh_and_single_phase(k20, monkeypatch):
    """``refresh_reselect=False`` (a fresh B1 capture at 4 probes) against
    ``MOLA_TPU_REFRESH_RESELECT=0``, then ``fused_refresh=False`` (one
    phase) against ``MOLA_TPU_FUSED_REFRESH=0``, both with the capture
    kernel on."""
    calls = _Calls(monkeypatch)
    _align_both(k20, monkeypatch, {"MOLA_TPU_PALLAS_CAPTURE": "1", "MOLA_TPU_REFRESH_RESELECT": "0"},
                dict(refresh_reselect=False))
    assert calls.n == dict(b1=[8, 4], b2=[], plain=[], b3=[16, 8], b4=0), calls.n
    calls = _Calls(monkeypatch)
    _, its = _align_both(k20, monkeypatch, {"MOLA_TPU_PALLAS_CAPTURE": "1", "MOLA_TPU_FUSED_REFRESH": "0"},
                         dict(fused_refresh=False))
    assert calls.n == dict(b1=[8], b2=[], plain=[], b3=[16], b4=0), calls.n
    assert max(its) <= ticp._FUSED_REFRESH_AT


def test_fused_align_off_and_the_knobs(k20, monkeypatch):
    """``fused_align=False`` on the fused-eligible configuration: the
    generic loop over the per-voxel view (kernel B4's twin, the capture
    once) against the JAX package with ``use_pallas`` off (its XLA select);
    then the nine ICP overrides of ``spec_from_yaml`` on both ICP blocks,
    and the CLI's six new flags against their variables."""
    calls = _Calls(monkeypatch)
    _, its = _align_both(k20, monkeypatch, {}, dict(fused_align=False), jcfg_edit=dict(use_pallas=False))
    assert calls.n["b1"] == calls.n["b2"] == calls.n["b3"] == [] and calls.n["plain"] == [8]
    assert calls.n["b4"] == max(its) + 1  # one select an iteration, one for the quality
    _spec_overrides(monkeypatch)
    _cli_flags(monkeypatch)


KNOBS9 = dict(per_voxel_nn=True, nn_neighbors=27, anderson_m=2, fused_align=False, capture_kernel=False,
              phase1_neighbors=4, refresh_reselect=False, refresh_neighbors=8, fused_refresh=False)


def _spec_overrides(monkeypatch):
    from mola_lidar_odometry_tpu_torch.models.spec import ICP_KNOBS, spec_from_yaml
    from mola_lidar_odometry_tpu_torch.utils.config import load_yaml_file

    assert set(ICP_KNOBS) == set(KNOBS9)
    path = os.path.join(HERE, "..", "pipelines", "lidar3d-default.yaml")
    cfg = load_yaml_file(path, env={})
    spec = spec_from_yaml(cfg, **KNOBS9)
    assert spec.icp_without_vel is spec.icp_with_vel  # no icp_settings_without_vel: one align a step
    two = dict(cfg, icp_settings_without_vel=cfg["icp_settings_with_vel"])
    plain = spec_from_yaml(two)
    for spec in (spec, spec_from_yaml(two, **KNOBS9)):
        for block in (spec.icp_with_vel, spec.icp_without_vel):
            assert {k: getattr(block, k) for k in KNOBS9} == KNOBS9
    for block in (plain.icp_with_vel, plain.icp_without_vel):  # none given: the JAX package's TPU setting
        assert (block.fused_align, block.capture_kernel, block.phase1_neighbors, block.refresh_reselect,
                block.refresh_neighbors, block.fused_refresh) == (True, True, None, True, None, True)
    assert spec_from_yaml(cfg, fused_align=None).icp_with_vel.fused_align  # None keeps the default


def _cli_flags(monkeypatch):
    from mola_lidar_odometry_tpu_torch.apps import cli

    for k in SWITCHES:
        monkeypatch.delenv(k, raising=False)
    base = ["-c", "pipelines/lidar3d-default.yaml", "--input-sim", "1", "--device", "cpu"]
    assert cli.icp_overrides(cli.build_parser().parse_args(base)) == {}
    env = {"MOLA_TPU_PALLAS": "0", "MOLA_TPU_PALLAS_CAPTURE": "0", "MOLA_TPU_PHASE1_NEIGHBORS": "4",
           "MOLA_TPU_REFRESH_RESELECT": "0", "MOLA_TPU_REFRESH_NEIGHBORS": "8", "MOLA_TPU_FUSED_REFRESH": "0"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    six = dict(fused_align=False, capture_kernel=False, phase1_neighbors=4, refresh_reselect=False,
               refresh_neighbors=8, fused_refresh=False)
    assert cli.icp_overrides(cli.build_parser().parse_args(base)) == six
    flags = ["--fused-align", "1", "--capture-kernel", "1", "--phase1-neighbors", "1", "--refresh-reselect", "1",
             "--refresh-neighbors", "1", "--fused-refresh", "1"]
    assert cli.icp_overrides(cli.build_parser().parse_args(base + flags)) == dict(
        fused_align=True, capture_kernel=True, phase1_neighbors=1, refresh_reselect=True, refresh_neighbors=1,
        fused_refresh=True)
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(base + ["--fused-refresh", "2"])
