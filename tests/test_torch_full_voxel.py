"""Port parity for the full-voxel capture: ``IcpConfig.per_voxel_nn=False``
in mola_lidar_odometry_tpu_torch against the JAX package at its defaults on
every backend but a TPU (``MOLA_TPU_PALLAS=0 MOLA_TPU_PER_VOXEL_NN=0``:
every point of each probed voxel is a candidate, the generic loop selects
the nearest in XLA).  The port selects over the same candidates on kernel
B4's plain twin (CPU tensors).

Held here, on seeded numpy inputs at small sizes, in five items: the
captured candidates bit for bit (``C = P*K``: 160 for lidar3d-default's 8
probes of a K = 20 map, 540 and 270 for lidar3d-dual-map's 27 probes of K
= 20 and 10) and B4's twin at C = 160 against the Pallas kernel in
interpret mode; the align of both pipelines' ICP blocks (the fused path
barred; pose within 1e-5, iterations equal); the fleet step of each over 4
frames (poses within 5e-3, quality within 0.02, iterations within one,
flags and counts equal, as ``test_torch_step_dualmap.py``); the three spec
overrides against the JAX package's environment variables with the CLI
flags' environment defaults.

Few items on purpose: xdist's ``--dist loadfile`` queues files by item
count, and a file queued ahead of the small ones shifts which file the
worker of ``tests/test_oracle_parity.py`` (the run's long pole) takes up
after it."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mola_lidar_odometry_tpu_torch.models.spec import spec_from_yaml as t_spec_from_yaml
from mola_lidar_odometry_tpu_torch.ops import icp as ticp, pallas_match as tpm, se3 as tse3, voxel_hash as tvh
from mola_lidar_odometry_tpu_torch.ops.pointcloud import PointCloud as TPC
from mola_lidar_odometry_tpu_torch.ops.solver import PosePrior as TPrior
from mola_lidar_odometry_tpu_torch.parallel import batch as tpb
from mola_lidar_odometry_tpu_torch.utils import sim
from mola_lidar_odometry_tpu_torch.utils.config import load_yaml_file as t_load

HERE = os.path.dirname(os.path.abspath(__file__))
PIPES = {
    "default": os.path.join(HERE, "..", "pipelines", "lidar3d-default.yaml"),
    "dual-map": os.path.join(HERE, "..", "pipelines", "extras", "lidar3d-dual-map.yaml"),
}
CPU_DEFAULTS = {"MOLA_TPU_PALLAS": "0", "MOLA_TPU_PER_VOXEL_NN": "0"}
KNOBS = ("MOLA_TPU_PALLAS", "MOLA_TPU_PER_VOXEL_NN", "MOLA_TPU_PALLAS_CAPTURE", "MOLA_TPU_NN_NEIGHBORS",
         "MOLA_TPU_ICP_ANDERSON")
MAP_K = {"localmap": 20, "localmap_far": 10}
LAYERS = {"decimated_for_icp": 300, "decimated_for_icp_near": 200}
B = 2


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_spec(pipe, env, **sizing):
    """The JAX package's spec built under ``env`` (its knobs are read when
    a spec is built), every other knob of it unset."""
    mp = pytest.MonkeyPatch()
    for k in KNOBS:
        mp.delenv(k, raising=False)
    for k, v in env.items():
        mp.setenv(k, v)
    try:
        from mola_lidar_odometry_tpu.models.spec import spec_from_yaml
        from mola_lidar_odometry_tpu.utils.config import load_yaml_file

        return spec_from_yaml(load_yaml_file(PIPES[pipe], env={}), **sizing)
    finally:
        mp.undo()


def _world(seed=0, n=3000):
    rng = np.random.default_rng(seed)
    g = rng.uniform(-15, 15, (n, 2)).astype(np.float32)
    floor = np.stack([g[:, 0], g[:, 1], np.zeros(n, np.float32)], 1)
    w1 = np.stack([g[: n // 2, 0], np.full(n // 2, 8.0, np.float32), rng.uniform(0, 4, n // 2).astype(np.float32)], 1)
    w2 = np.stack([np.full(n // 2, -6.0, np.float32), g[n // 2 :, 1], rng.uniform(0, 4, n // 2).astype(np.float32)], 1)
    return np.concatenate([floor, w1, w2]).astype(np.float32)


@pytest.fixture(scope="module")
def scene():
    """The two maps of one world (K = 20 and 10, four inserts of it, each
    moved by up to 3 cm, so the probed voxels hold many points), the two
    ICP layers seen from a true pose, two entry poses (4 cm and 12 cm off)
    and a per-instance sigma."""
    from mola_lidar_odometry_tpu.ops import se3 as jse3, voxel_hash as jvh
    from mola_lidar_odometry_tpu.ops.se3 import Pose as JPose

    pts = _world()
    rng = np.random.default_rng(1)
    jmaps, tmaps = {}, {}
    for name, K in MAP_K.items():
        tm = tvh.VoxelHashMap.create(1 << 13, K, 1.0, batch=B, device="cpu")
        for _ in range(4):
            moved = pts + rng.uniform(-0.03, 0.03, pts.shape).astype(np.float32)
            tm, _ = tvh.insert_stats(tm, TPC.from_xyz(torch.from_numpy(np.stack([moved] * B))))
        tmaps[name] = tm
        # the JAX map takes the port's table (the layout is shared word for
        # word; tests/test_torch_voxel_hash.py holds the inserts together)
        jmaps[name] = jvh.VoxelHashMap.create(1 << 13, K, 1.0)._replace(data=jnp.asarray(tm.data[0].numpy()))
    true_pose = JPose(jse3.so3_exp(jnp.asarray([0.004, -0.006, 0.02], jnp.float32)),
                      jnp.asarray([0.15, -0.08, 0.02], jnp.float32))
    inv = JPose(true_pose.R.T, -true_pose.R.T @ true_pose.t)
    layers = {}
    for name, n in LAYERS.items():
        sel = rng.choice(len(pts), n, replace=False)
        world_q = jnp.asarray(pts[sel] + rng.normal(0, 0.01, (n, 3)).astype(np.float32))
        valid = np.ones((n,), bool)
        valid[::13] = False
        layers[name] = (np.asarray(jse3.transform(inv, world_q)), valid)
    off = np.array([[0.04, 0.0, 0.0, 0, 0, 0.001], [-0.06, 0.1, 0.01, 0.002, 0, -0.004]], np.float32)
    entry = [jse3.compose(jse3.se3_exp(jnp.asarray(x)), true_pose) for x in off]
    return dict(jmaps=jmaps, tmaps=tmaps, layers=layers, sig=np.array([1.0, 1.2], np.float32),
                entry_R=np.stack([np.asarray(P.R) for P in entry]), entry_t=np.stack([np.asarray(P.t) for P in entry]))


def _icp_blocks(pipe):
    """(the JAX package's ICP block at its CPU defaults, the port's with
    ``per_voxel_nn=False``) of ``pipe``."""
    jcfg = _jax_spec(pipe, CPU_DEFAULTS).icp_with_vel
    tcfg = t_spec_from_yaml(t_load(PIPES[pipe], env={}), per_voxel_nn=False).icp_with_vel
    assert not jcfg.per_voxel_nn and not jcfg.use_pallas and not tcfg.per_voxel_nn
    assert jcfg.nn_neighbors == tcfg.nn_neighbors == (8 if pipe == "default" else 27)
    return jcfg, tcfg


def _torch_layers(s):
    T = torch.from_numpy
    return {k: (T(np.stack([x] * B)), T(np.stack([v] * B))) for k, (x, v) in s["layers"].items()}


def test_capture_and_select_full_voxel(scene):
    """``_capture_all`` without the per-voxel view: every point of each
    probed voxel, the port's planar planes equal to the JAX package's
    ``CandSet`` word for word (C = P*K), at the entry pose; then kernel B4's
    twin over such planes against the Pallas kernel (``_b4_twin_at_c160``)."""
    from mola_lidar_odometry_tpu.ops import icp as jicp
    from mola_lidar_odometry_tpu.ops.se3 import Pose as JPose

    tl = _torch_layers(scene)
    jl = {k: (jnp.asarray(x), jnp.asarray(v)) for k, (x, v) in scene["layers"].items()}
    pose = tse3.Pose(torch.from_numpy(scene["entry_R"]), torch.from_numpy(scene["entry_t"]))
    widths = []
    for pipe in ("default", "dual-map"):
        jcfg, tcfg = _icp_blocks(pipe)
        tsets = ticp._capture_all(tcfg, scene["tmaps"], tl, pose)
        jcapture = jax.jit(lambda R, t, jcfg=jcfg: jicp._capture_all(jcfg, scene["jmaps"], jl, JPose(R, t)))
        for b in range(B):
            jsets = jcapture(scene["entry_R"][b], scene["entry_t"][b])
            for mc, ts, js in zip(tcfg.matchers, tsets, jsets):
                assert isinstance(ts, tpm.PlanarCands)
                C = tcfg.nn_neighbors * MAP_K[mc.global_layer]
                assert ts.x.shape == (B, LAYERS[mc.local_layer], C) and np.asarray(js.mask).shape[-1] == C
                pts, mask = np.asarray(js.pts), np.asarray(js.mask)
                for i, plane in enumerate((ts.x, ts.y, ts.z)):
                    np.testing.assert_array_equal(plane[b].numpy(), pts[..., i])
                np.testing.assert_array_equal(ts.mask[b].numpy() > 0, mask)
                assert mask.sum(-1).max() > 2 * tcfg.nn_neighbors  # more than the per-voxel view keeps
                widths.append(C)
    assert sorted(set(widths)) == [160, 270, 540]
    _b4_twin_at_c160(scene)


def _align_case(scene, pipe, monkeypatch):
    """The port's align of ``pipe``'s ICP block at B = 2 without the
    per-voxel view (the fused path patched to raise), against the JAX
    package's per instance at its CPU defaults: pose within 1e-5, the same
    iterations, hook and convergence flags, quality within 1e-5."""
    from mola_lidar_odometry_tpu.ops import icp as jicp
    from mola_lidar_odometry_tpu.ops.se3 import Pose as JPose
    from mola_lidar_odometry_tpu.ops.solver import PosePrior as JPrior

    jcfg, tcfg = _icp_blocks(pipe)
    assert ticp._fused_eligible(tcfg) == (pipe == "default")  # only per_voxel_nn bars the fused path

    def refuse(*a, **k):
        raise AssertionError("the fused path ran without per_voxel_nn")

    monkeypatch.setattr(ticp, "_align_fused_call", refuse)
    T = torch.from_numpy
    eye = np.stack([np.eye(3, dtype=np.float32)] * B)
    zero3, info = np.zeros((B, 3), np.float32), np.zeros((B, 6, 6), np.float32)
    launches = tpm.nn_select.launches
    res = ticp.align(scene["tmaps"], _torch_layers(scene), tse3.Pose(T(scene["entry_R"]), T(scene["entry_t"])),
                     TPrior(tse3.Pose(T(eye), T(zero3)), T(info)), tcfg,
                     {"ADAPTIVE_THRESHOLD_SIGMA": T(scene["sig"])})
    assert tpm.nn_select.launches == launches  # CPU tensors: the plain twin
    jl = {k: (jnp.asarray(x), jnp.asarray(v)) for k, (x, v) in scene["layers"].items()}

    @jax.jit
    def ref(eR, et, sig):
        prior = JPrior(JPose(jnp.eye(3, dtype=jnp.float32), jnp.zeros(3, jnp.float32)), jnp.zeros((6, 6), jnp.float32))
        return jicp.align(scene["jmaps"], jl, JPose(eR, et), prior, jcfg, {"ADAPTIVE_THRESHOLD_SIGMA": sig})

    its = []
    for b in range(B):
        r = ref(scene["entry_R"][b], scene["entry_t"][b], scene["sig"][b])
        np.testing.assert_allclose(res.pose.R[b].numpy(), np.asarray(r.pose.R), atol=1e-5, err_msg=f"R[{b}]")
        np.testing.assert_allclose(res.pose.t[b].numpy(), np.asarray(r.pose.t), atol=1e-5, err_msg=f"t[{b}]")
        assert int(res.iterations[b]) == int(r.iterations), (b, res.iterations, r.iterations)
        assert abs(float(res.quality[b]) - float(r.quality)) <= 1e-5, (b, res.quality, r.quality)
        assert bool(res.hook_stop[b]) == bool(r.hook_stop) and bool(res.converged[b]) == bool(r.converged)
        its.append(int(r.iterations))
    assert min(its) > 2 and float(res.quality.min()) > 0.8  # a real align, not a first-iteration exit
    return res


def test_align_full_voxel_matches_jax(scene, monkeypatch):
    for pipe in ("default", "dual-map"):
        _align_case(scene, pipe, monkeypatch)


# -- the fleet step over a few frames ---------------------------------------
STEP_SIZING = {
    "default": dict(raw_capacity=1 << 13, map_slots=1 << 14, layer_capacities={
        "raw": 1 << 13, "decimated_for_map_raw": 4096, "decimated_for_icp_skewed": 2048,
        "decimated_for_icp": 2048, "decimated_for_map": 4096}),
    "dual-map": dict(raw_capacity=1 << 13, map_slots=1 << 14, layer_capacities={
        "raw": 1 << 13, "decimated_for_map_raw": 4096, "decimated_for_map_skewed": 4096,
        "decimated_for_map": 4096, "decimated_for_icp_skewed": 2048, "decimated_for_icp": 2048,
        "decimated_for_icp_near_skewed": 2048, "decimated_for_icp_near": 2048}),
}
FRAMES = 4


@pytest.mark.parametrize("pipe", ["default", "dual-map"])
def test_fleet_step_full_voxel_matches_jax(pipe):
    """B = 2 (two simulated 16 x 512 sequences) over 4 frames: the port with
    ``per_voxel_nn=False`` against the JAX package's fleet step at its CPU
    defaults."""
    from mola_lidar_odometry_tpu.parallel import batch as jpb

    sizing = STEP_SIZING[pipe]
    seqs = [sim.simulate_sequence(FRAMES, traj_seed=s, n_rings=16, n_azimuth=512) for s in (1, 2)]
    jspec = _jax_spec(pipe, CPU_DEFAULTS, **sizing)
    tspec = t_spec_from_yaml(t_load(PIPES[pipe], env={}), per_voxel_nn=False, **sizing)
    assert not (jspec.icp_with_vel.per_voxel_nn or tspec.icp_with_vel.per_voxel_nn or tspec.icp_without_vel.per_voxel_nn)
    jstep, tstep = jax.jit(jpb.make_fleet_step(jspec)), tpb.make_fleet_step(tspec)
    jc, tc = jpb.init_fleet_carry(jspec, B), tpb.init_fleet_carry(tspec, B, device="cpu")
    qs = []
    for k in range(FRAMES):
        scans, stamps = [seqs[b][1][k] for b in range(B)], [seqs[b][0].stamps[k] for b in range(B)]
        jc, jo = jstep(jc, jpb.pack_scans(jspec, scans, stamps))
        tc, to = tstep(tc, tpb.pack_scans(tspec, scans, stamps, device="cpu"))
        jo = jax.tree_util.tree_map(np.asarray, jo)
        for f in ("n_raw", "n_icp_layer", "n_map_layer", "accepted", "kf_local", "corrections",
                  "map_collision_drops", "map_full_drops", "deferred_drops"):
            np.testing.assert_array_equal(getattr(to, f).numpy(), getattr(jo, f), err_msg=f"{f} at frame {k}")
        np.testing.assert_allclose(to.pose_t.numpy(), jo.pose_t, atol=5e-3, err_msg=f"t at frame {k}")
        np.testing.assert_allclose(to.pose_R.numpy(), jo.pose_R, atol=5e-3, err_msg=f"R at frame {k}")
        assert np.all(np.abs(to.iterations.numpy() - jo.iterations) <= 1), (k, to.iterations, jo.iterations)
        np.testing.assert_allclose(to.quality.numpy(), jo.quality, atol=0.02, err_msg=f"quality at frame {k}")
        qs.append(to.quality.numpy())
    assert np.mean(qs[1:]) > 0.8 and int(to.iterations.min()) > 0


def test_icp_knobs_reach_the_spec_and_the_cli(monkeypatch):
    _spec_overrides_match_the_jax_environment()
    _cli_flags_take_their_environment_defaults(monkeypatch)


def _spec_overrides_match_the_jax_environment():
    """``spec_from_yaml``'s three ICP overrides against the JAX package's
    spec built under ``MOLA_TPU_PER_VOXEL_NN``, ``MOLA_TPU_NN_NEIGHBORS``
    and ``MOLA_TPU_ICP_ANDERSON``, field by field on both ICP blocks; with
    none given, the port's blocks equal the JAX package's TPU setting; the
    host API passes them through."""
    from mola_lidar_odometry_tpu_torch.models.odometry import LidarOdometry

    def same(jblock, tblock):
        for f in dataclasses.fields(tblock):
            if f.name == "matchers":
                assert len(jblock.matchers) == len(tblock.matchers)
                continue
            if not hasattr(jblock, f.name):  # the fused path's switches: read by the JAX package's align
                continue
            jv, tv = getattr(jblock, f.name), getattr(tblock, f.name)
            assert str(jv) == str(tv), (f.name, jv, tv)

    cases = [({"MOLA_TPU_PER_VOXEL_NN": "0", "MOLA_TPU_NN_NEIGHBORS": "27", "MOLA_TPU_ICP_ANDERSON": "3"},
              dict(per_voxel_nn=False, nn_neighbors=27, anderson_m=3)),
             ({"MOLA_TPU_PER_VOXEL_NN": "0"}, dict(per_voxel_nn=False)),
             ({"MOLA_TPU_PER_VOXEL_NN": "1", "MOLA_TPU_NN_NEIGHBORS": "8"}, dict(nn_neighbors=8)),
             ({"MOLA_TPU_PER_VOXEL_NN": "1"}, dict(per_voxel_nn=None, anderson_m=None))]
    for pipe in PIPES:
        for env, kw in cases:
            js = _jax_spec(pipe, env)
            ts = t_spec_from_yaml(t_load(PIPES[pipe], env={}), **kw)
            for block in ("icp_with_vel", "icp_without_vel"):
                same(getattr(js, block), getattr(ts, block))
    lo = LidarOdometry.from_yaml_file(PIPES["default"], env={}, device="cpu", per_voxel_nn=False, nn_neighbors=27,
                                      anderson_m=2)
    for block in (lo.spec.icp_with_vel, lo.spec.icp_without_vel):
        assert (block.per_voxel_nn, block.nn_neighbors, block.anderson_m) == (False, 27, 2)
    assert lo.spec.icp_without_vel is lo.spec.icp_with_vel  # no icp_settings_without_vel: one align a step
    assert lo._auto_cfg[1] == dict(per_voxel_nn=False, nn_neighbors=27, anderson_m=2)  # kept for the sizing rebuild


def _cli_flags_take_their_environment_defaults(monkeypatch):
    """``--per-voxel-nn``, ``--nn-neighbors`` and ``--icp-anderson`` default
    to the JAX CLI's variables; a flag beats its variable; the derived
    sizing and the spec of a run both see them."""
    from mola_lidar_odometry_tpu_torch.apps import cli, datasets

    for k in KNOBS + ("MOLA_TPU_RAW_CAPACITY", "MOLA_TPU_MAP_SLOTS"):
        monkeypatch.delenv(k, raising=False)
    base = ["-c", PIPES["default"], "--input-sim", "1", "--device", "cpu"]
    assert cli.icp_overrides(cli.build_parser().parse_args(base)) == {}
    monkeypatch.setenv("MOLA_TPU_PER_VOXEL_NN", "0")
    monkeypatch.setenv("MOLA_TPU_NN_NEIGHBORS", "27")
    monkeypatch.setenv("MOLA_TPU_ICP_ANDERSON", "3")
    assert cli.icp_overrides(cli.build_parser().parse_args(base)) == dict(per_voxel_nn=False, nn_neighbors=27,
                                                                          anderson_m=3)
    assert cli.icp_overrides(cli.build_parser().parse_args(base + ["--per-voxel-nn", "1", "--icp-anderson", "0"])) \
        == dict(per_voxel_nn=True, nn_neighbors=27, anderson_m=0)
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(base + ["--per-voxel-nn", "2"])

    import mola_lidar_odometry_tpu_torch.models.spec as spec_mod  # the CLI imports spec_from_yaml in run()

    seen = []

    orig = spec_mod.spec_from_yaml

    def spy(cfg, **kw):
        seen.append({k: kw.get(k) for k in ("per_voxel_nn", "nn_neighbors", "anderson_m", "raw_capacity")})
        return orig(cfg, **kw)

    monkeypatch.setattr(spec_mod, "spec_from_yaml", spy)
    monkeypatch.setattr(cli, "make_dataset", lambda args: datasets.SimDataset(1, n_rings=8, n_azimuth=256))
    lo = cli.run(base)
    assert seen[0]["raw_capacity"] is None and seen[-1]["raw_capacity"] is not None  # derived, then built
    assert all((s["per_voxel_nn"], s["nn_neighbors"], s["anderson_m"]) == (False, 27, 3) for s in seen)
    assert (lo.spec.icp_with_vel.per_voxel_nn, lo.spec.icp_with_vel.nn_neighbors, lo.spec.icp_with_vel.anderson_m) \
        == (False, 27, 3)


def _b4_twin_at_c160(scene):
    """B4's plain twin over lidar3d-default's full-voxel planes (8 probes x
    K = 20 = 160 candidates) against the JAX package's ``nn_select`` kernel
    in interpret mode (its lanes padded to 256): distances within rtol 1e-6
    (XLA may contract the sum into fused multiply-adds), 3.4e38 exactly for
    queries with no candidate, the same target wherever the two best
    distances are apart."""
    from mola_lidar_odometry_tpu.ops import pallas_match as jpm, voxel_hash as jvh

    q, valid = scene["layers"]["decimated_for_icp"]
    q = np.stack([q, q * 1.3 + 0.4]).astype(np.float32)  # instance 1 partly off the map: empty rows
    tq = torch.from_numpy(q)
    planar = tpm.to_planar(tvh.capture(scene["tmaps"]["localmap"], tq, 8, per_voxel_nn=False))
    assert planar.x.shape == (B, q.shape[1], 160)
    tgt, d2 = tpm.nn_select(planar, tq)  # CPU tensors: the plain twin
    d2all = (planar.x - tq[..., 0:1]) ** 2 + (planar.y - tq[..., 1:2]) ** 2 + (planar.z - tq[..., 2:3]) ** 2
    two = torch.topk(torch.where(planar.mask > 0, d2all, torch.inf), 2, dim=-1, largest=False).values
    gap = ((two[..., 1] - two[..., 0]) / torch.clamp(two[..., 0], min=1e-12)).numpy()
    n_none = 0
    for b in range(B):
        jplanar = jpm.to_planar(jvh.capture(scene["jmaps"]["localmap"], jnp.asarray(q[b]), 8, False))
        for tp, jp in zip(planar, jplanar):
            np.testing.assert_array_equal(tp[b].numpy(), np.asarray(jp)[:, :160])
        jtgt, jd2 = (np.asarray(x) for x in jpm.nn_select(jplanar, jnp.asarray(q[b]), interpret=True))
        np.testing.assert_allclose(d2[b].numpy(), jd2, rtol=1e-6)
        none = jd2 > 1e37
        np.testing.assert_array_equal(d2[b].numpy()[none], jd2[none])
        clear = none | (gap[b] > 1e-6)
        np.testing.assert_array_equal(tgt[b].numpy()[clear], jtgt[clear])
        assert clear.mean() > 0.99
        n_none += int(none.sum())
    assert n_none > 0
