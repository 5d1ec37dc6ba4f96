"""Port parity for the host API: ``LidarOdometry`` of
mola_lidar_odometry_tpu_torch (``device="cpu"``) against the JAX package's.

The JAX package runs its TPU algorithm on the CPU (``MOLA_TPU_PALLAS=1
MOLA_TPU_PER_VOXEL_NN=1 MOLA_TPU_PALLAS_CAPTURE=1``, the Pallas kernels in
interpret mode) for lidar3d-default, and ``MOLA_TPU_PER_VOXEL_NN=1
MOLA_TPU_PALLAS=0`` for lidar3d-dual-map (the XLA twin of its nearest-select
kernel), as the step parity tests do.  Both step the same simulated frames
(seeded): per frame the accepted and keyframe flags and the layer counts
must match exactly, poses within 5e-3 and quality within 0.02, and the
trajectory stamps are equal in float64.  Then the host surface: auto-sizing,
``pin_se2`` auto, wheel odometry, relocalization, the mapping toggle, the
GNSS/IMU buffers, publisher callbacks, the fatal latch and ``reset``, a
local map saved by one package stepped by the other, and simple-maps read
both ways."""

import os

import numpy as np
import pytest
import torch

from mola_lidar_odometry_tpu_torch.models.odometry import LidarOdometry as TLO, output_to_host
from mola_lidar_odometry_tpu_torch.utils import serialization as tser, sim

HERE = os.path.dirname(os.path.abspath(__file__))
DEFAULT = os.path.join(HERE, "..", "pipelines", "lidar3d-default.yaml")
DUALMAP = os.path.join(HERE, "..", "pipelines", "extras", "lidar3d-dual-map.yaml")
CAPS = dict(  # the small capacities of the verify notes
    raw_capacity=1 << 15, map_slots=1 << 16,
    layer_capacities={"raw": 1 << 15, "decimated_for_map_raw": 16384, "decimated_for_icp_skewed": 8192,
                      "decimated_for_icp": 8192, "decimated_for_map": 16384},
)
KNOBS = {
    DEFAULT: {"MOLA_TPU_PALLAS": "1", "MOLA_TPU_PER_VOXEL_NN": "1", "MOLA_TPU_PALLAS_CAPTURE": "1"},
    DUALMAP: {"MOLA_TPU_PALLAS": "0", "MOLA_TPU_PER_VOXEL_NN": "1"},
}
FRAMES = 5
FLAGS = ("processed", "accepted", "kf_local", "kf_simplemap", "sm_insert", "n_raw", "n_icp_layer", "n_map_layer",
         "corrections")


def _jax_lo(pipe, env, **kw):
    from mola_lidar_odometry_tpu.models.odometry import LidarOdometry

    return LidarOdometry.from_yaml_file(pipe, env=env, **kw)


def _feed(lo, scans, traj, k, **kw):
    xyz, times, rings, valid = scans[k]
    return lo.on_lidar_scan(xyz[valid], traj.stamps[k], times=times[valid], ring=rings[valid], **kw)


def _compare(jo, to, k):
    for f in FLAGS:
        np.testing.assert_array_equal(getattr(to, f), np.asarray(getattr(jo, f)), err_msg=f"{f} frame {k}")
    np.testing.assert_allclose(to.pose_t, np.asarray(jo.pose_t), atol=5e-3)
    np.testing.assert_allclose(to.pose_R, np.asarray(jo.pose_R), atol=5e-3)
    np.testing.assert_allclose(float(to.quality), float(jo.quality), atol=0.02)


def _run_both(pipe, frames, env, scans_kw, gnss=False, **caps):
    mp = pytest.MonkeyPatch()
    for k, v in KNOBS[pipe].items():
        mp.setenv(k, v)  # read when the JAX spec is built and traced
    try:
        traj, scans = sim.simulate_sequence(frames, **scans_kw)
        jlo, tlo = _jax_lo(pipe, env, **caps), TLO.from_yaml_file(pipe, env=env, device="cpu", **caps)
        jouts, touts = [], []
        for k in range(frames):
            for lo in (jlo, tlo):
                if gnss:  # a fix 0.2 s before every scan
                    lo.on_gnss(traj.stamps[k] - 0.2, {"enu": traj.t[k].tolist()})
                lo.on_imu(traj.stamps[k], {"wz": 0.1 * k})
            jouts.append(_feed(jlo, scans, traj, k))
            touts.append(_feed(tlo, scans, traj, k))
        return dict(traj=traj, scans=scans, jlo=jlo, tlo=tlo, jouts=jouts, touts=touts)
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def fixed():
    """lidar3d-default at the verify capacities, simple-map on, GNSS fed."""
    return _run_both(DEFAULT, FRAMES, {"MOLA_GENERATE_SIMPLEMAP": "true"}, {}, gnss=True, **CAPS)


def test_frames_match_jax(fixed):
    for k, (jo, to) in enumerate(zip(fixed["jouts"], fixed["touts"])):
        _compare(jo, to, k)
        assert to.pose_R.shape == (3, 3) and to.n_raw.shape == ()
    assert sum(bool(o.accepted) for o in fixed["touts"]) == FRAMES
    jt, tt = fixed["jlo"].estimated_trajectory(), fixed["tlo"].estimated_trajectory()
    assert tt["stamps"].dtype == np.float64 and np.array_equal(tt["stamps"], jt["stamps"])
    np.testing.assert_allclose(tt["t"], jt["t"], atol=5e-3)
    np.testing.assert_allclose(np.abs(tt["quat_xyzw"]), np.abs(jt["quat_xyzw"]), atol=5e-3)


def test_simplemap_and_gnss_buffers_match_jax(fixed):
    jsm, tsm = fixed["jlo"].reconstructed_map(), fixed["tlo"].reconstructed_map()
    assert len(tsm) == len(jsm) > 1
    for j, t in zip(jsm, tsm):
        assert t.stamp == j.stamp
        assert (t.scan_xyz is None) == (j.scan_xyz is None)
        assert t.gnss == j.gnss and t.gnss is not None
        assert t.metadata == j.metadata
    assert len(fixed["tlo"]._imu_buffer) == FRAMES and len(fixed["tlo"]._gnss_buffer) == FRAMES


def test_simplemap_round_trips_both_ways(fixed, tmp_path):
    from mola_lidar_odometry_tpu.utils import serialization as jser

    for save, load, lo in ((tser.save_simplemap, jser.load_simplemap, fixed["tlo"]),
                           (jser.save_simplemap, tser.load_simplemap, fixed["jlo"])):
        for lazy in (False, True):
            path = tmp_path / f"{save.__module__.split('.')[0]}_{lazy}.simplemap"
            save(path, lo.reconstructed_map(), lazy_load=lazy)
            back = load(path)
            assert len(back) == len(lo.reconstructed_map())
            for a, b in zip(back, lo.reconstructed_map()):
                assert a.stamp == b.stamp and a.gnss == b.gnss
                np.testing.assert_array_equal(a.t, b.t)
                np.testing.assert_array_equal(a.quat_xyzw, b.quat_xyzw)
                if b.scan_xyz is None:
                    assert a.scan_xyz is None
                else:
                    np.testing.assert_array_equal(a.scan_xyz, b.scan_xyz.astype(np.float32))
                assert (a.scan_path is not None) == (lazy and b.scan_xyz is not None)


@pytest.mark.parametrize("pipe", [DEFAULT, DUALMAP], ids=["default", "dual-map"])
def test_auto_sizing_matches_jax(pipe):
    """No capacity given: both size every buffer from the first scan (the
    same integers), then step the same frames."""
    r = _run_both(pipe, 4, {}, dict(n_rings=32, n_azimuth=1024))
    js, ts = r["jlo"].spec, r["tlo"].spec
    assert ts.raw_capacity == js.raw_capacity == 40960
    assert ts.layer_capacities == js.layer_capacities
    assert [(d.name, d.num_slots, d.insert_budget) for d in ts.map_layers] == [
        (d.name, d.num_slots, d.insert_budget) for d in js.map_layers]
    assert ts.pin_se2 is False and js.pin_se2 is False
    for k, (jo, to) in enumerate(zip(r["jouts"], r["touts"])):
        _compare(jo, to, k)
    assert np.array_equal(r["tlo"].estimated_trajectory()["stamps"], r["jlo"].estimated_trajectory()["stamps"])
    assert tuple(r["tlo"].carry.maps[ts.map_layers[0].name].data.shape) == (1, ts.map_layers[0].num_slots // 4, 128)


def test_pin_se2_auto_resolves_from_a_planar_scan():
    rng = np.random.default_rng(1)
    planar = np.c_[rng.uniform(-20, 20, (3000, 2)), np.zeros(3000)].astype(np.float32)
    for xyz, want in ((planar, True), (planar + np.float32([0, 0, 0.3]), False)):
        jlo, tlo = _jax_lo(DEFAULT, {}, **CAPS), TLO.from_yaml_file(DEFAULT, env={}, device="cpu", **CAPS)
        assert tlo.spec.pin_se2 is None and tlo._step is None
        jlo._ensure_step(xyz)
        tlo._ensure_step(xyz)
        assert tlo.spec.pin_se2 is want and jlo.spec.pin_se2 is want
    out = tlo.on_lidar_scan(planar, 5.0)
    assert bool(out.processed) and bool(out.accepted)


@pytest.fixture
def tiny():
    return TLO.from_yaml_file(DEFAULT, env={}, device="cpu", **CAPS)


def test_wheel_odometry_feeds_navstate_as_jax(tiny):
    """Odometry is velocity evidence only: the navstate window advances as
    in the JAX package, the pose estimate does not move."""
    from mola_lidar_odometry_tpu.models import navstate as jns
    from mola_lidar_odometry_tpu_torch.models import navstate as tns

    jlo = _jax_lo(DEFAULT, {}, **CAPS)
    for lo in (jlo, tiny):
        for k, x in enumerate((0.0, 0.5, 1.0)):
            T = np.eye(4)
            T[:3, 3] = [x, 0.02 * k, 0.0]
            lo.on_wheel_odometry(10.0 + 0.1 * k, T)
    assert abs(float(tiny.carry.pose_t[0, 0])) < 1e-6
    jnav, tnav = jlo.carry.nav, tiny.carry.nav
    assert int(tnav.head[0]) == int(jnav.head) == 2
    np.testing.assert_array_equal(tnav.valid[0].numpy(), np.asarray(jnav.valid))
    np.testing.assert_allclose(tnav.t[0].numpy(), np.asarray(jnav.t), atol=1e-6)
    np.testing.assert_allclose(tnav.times[0].numpy(), np.asarray(jnav.times), atol=1e-6)
    est = tns.estimate(tnav, tiny.spec.navstate, torch.tensor([0.25]))
    jest = jns.estimate(jnav, jlo.spec.navstate, 0.25)
    assert bool(est.valid[0]) and bool(jest.valid)
    np.testing.assert_allclose(est.twist[0].numpy(), np.asarray(jest.twist), atol=1e-4)
    assert abs(float(est.twist[0, 0]) - 5.0) < 1.0  # ~0.5 m / 0.1 s


def test_relocalization(tiny):
    tiny.relocalize_near_pose_pdf(np.eye(3), np.asarray([10.0, -3.0, 1.0]))
    np.testing.assert_allclose(tiny.carry.pose_t[0].numpy(), [10.0, -3.0, 1.0], atol=1e-6)
    assert tiny.carry.pose_R.shape == (1, 3, 3) and not bool(tiny.carry.nav.valid.any())
    assert float(tiny.carry.sigma[0]) == 0.0
    tiny.reset()
    assert not tiny.relocalize_from_gnss()  # nothing buffered
    tiny.on_gnss(1.0, {"enu": [5.0, 6.0, 0.0]})
    assert tiny.relocalize_from_gnss()
    np.testing.assert_allclose(tiny.carry.pose_t[0].numpy(), [5.0, 6.0, 0.0])


def test_mapping_toggle_matches_jax():
    """With mapping off, frames keep matching against the frozen map: no
    keyframe, the table unchanged, the same flags as the JAX package."""
    mp = pytest.MonkeyPatch()
    for k, v in KNOBS[DEFAULT].items():
        mp.setenv(k, v)
    try:
        traj, scans = sim.simulate_sequence(4, n_rings=16, n_azimuth=512)
        jlo, tlo = _jax_lo(DEFAULT, {}, **CAPS), TLO.from_yaml_file(DEFAULT, env={}, device="cpu", **CAPS)
        for k in range(2):
            _compare(_feed(jlo, scans, traj, k), _feed(tlo, scans, traj, k), k)
        for lo in (jlo, tlo):
            lo.set_mapping_enabled(False)
            assert not lo.mapping_enabled
        before = tlo.carry.maps["localmap"].data.clone()
        for k in range(2, 4):
            jo, to = _feed(jlo, scans, traj, k), _feed(tlo, scans, traj, k)
            _compare(jo, to, k)
            assert bool(to.accepted) and not bool(to.kf_local)
        assert torch.equal(tlo.carry.maps["localmap"].data, before)
        tlo.set_mapping_enabled(True)
        assert tlo.mapping_enabled and tlo.carry.mapping_enabled.shape == (1,)
    finally:
        mp.undo()


def test_publisher_callbacks(tiny):
    """advertiseUpdatedLocalization / advertiseUpdatedMap counterparts; the
    map view is the live table's points, unwrapped near the pose."""
    loc_updates, map_updates = [], []
    tiny.subscribe_localization_updates(loc_updates.append)
    tiny.subscribe_map_updates(map_updates.append)
    tiny.publish_map_updates_every_n = 1
    traj, scans = sim.simulate_sequence(3, n_rings=8, n_azimuth=128)
    for k in range(3):
        _feed(tiny, scans, traj, k)
    assert len(loc_updates) == 3 and loc_updates[0]["t"].shape == (3,)
    assert len(map_updates) >= 1 and map_updates[0].ndim == 2 and map_updates[0].shape[1] == 3
    n_live = int(tiny.carry.maps["localmap"].count().sum())
    assert len(map_updates[-1]) == n_live > 0
    assert np.all(np.abs(map_updates[-1] - traj.t[-1]) < 200.0)


def test_local_map_points_match_jax_anchor_unwrap():
    """``as_pointcloud`` of one table, far beyond the key wrap range of the
    origin, unwrapped near the pose, in both packages."""
    import jax.numpy as jnp

    from mola_lidar_odometry_tpu.ops import maps as jmaps, voxel_hash as jvh
    from mola_lidar_odometry_tpu_torch.ops import maps as tmaps, voxel_hash as tvh
    from mola_lidar_odometry_tpu_torch.ops.pointcloud import PointCloud

    rng = np.random.default_rng(2)
    center = np.float32([3100.0, -2600.0, 40.0])
    pts = (center + rng.uniform(-30, 30, (4000, 3))).astype(np.float32)
    tm = tvh.VoxelHashMap.create(1 << 12, 20, 1.0, batch=1, device="cpu")
    tm, _ = tvh.insert_stats(tm, PointCloud.from_xyz(torch.from_numpy(pts)[None]))
    jm = jvh.VoxelHashMap(jnp.float32(1.0), jnp.asarray(tm.data[0].numpy()), jnp.int32(1), K=tm.K, stride=tm.stride)
    tpc = tmaps.as_pointcloud(tm, 1 << 14, anchor=torch.from_numpy(center)[None])
    jpc = jmaps.as_pointcloud(jm, 1 << 14, anchor=jnp.asarray(center))
    np.testing.assert_array_equal(tpc.valid[0].numpy(), np.asarray(jpc.valid))
    np.testing.assert_array_equal(tpc.xyz[0].numpy(), np.asarray(jpc.xyz))
    assert np.abs(tpc.xyz[0][tpc.valid[0]].numpy() - center).max() < 31.0


def test_local_map_saved_by_jax_steps_in_the_port(tmp_path):
    """A local map the JAX package saved loads into the port word for word,
    and both packages step the next frame from it identically; the port's
    save reads back into the JAX package."""
    from mola_lidar_odometry_tpu.utils import serialization as jser

    mp = pytest.MonkeyPatch()
    for k, v in KNOBS[DEFAULT].items():
        mp.setenv(k, v)
    try:
        traj, scans = sim.simulate_sequence(4, n_rings=16, n_azimuth=512)
        jlo = _jax_lo(DEFAULT, {}, **CAPS)
        for k in range(3):
            _feed(jlo, scans, traj, k)
        path = tmp_path / "session.mm"
        jlo.save_local_map(path)
        jfresh, tfresh = _jax_lo(DEFAULT, {}, **CAPS), TLO.from_yaml_file(DEFAULT, env={}, device="cpu", **CAPS)
        jfresh.load_local_map(path)
        tfresh.load_local_map(path)
        jm, tm = jfresh.carry.maps["localmap"], tfresh.carry.maps["localmap"]
        np.testing.assert_array_equal(tm.data[0].numpy(), np.asarray(jm.data))
        assert (tm.K, tm.stride, int(tm.epoch[0]), float(tm.voxel_size[0])) == (
            jm.K, jm.stride, int(jm.epoch), float(jm.voxel_size))
        assert bool(tfresh.carry.map_has_content[0])
        for lo in (jfresh, tfresh):
            lo.relocalize_near_pose_pdf(np.asarray(jlo.carry.pose_R), np.asarray(jlo.carry.pose_t))
        _compare(_feed(jfresh, scans, traj, 3), _feed(tfresh, scans, traj, 3), 3)
        np.testing.assert_array_equal(tfresh.carry.maps["localmap"].data[0].numpy(),
                                      np.asarray(jfresh.carry.maps["localmap"].data))
        tfresh.save_local_map(tmp_path / "port.mm")
        back = jser.load_metric_map(tmp_path / "port.mm")["localmap"]
        np.testing.assert_array_equal(np.asarray(back.data), tfresh.carry.maps["localmap"].data[0].numpy())
    finally:
        mp.undo()


def test_auto_sizing_drops_a_preloaded_local_map_as_jax(tmp_path):
    """With ``load_existing_local_map`` and capacity auto-sizing, both
    packages preload the map, then rebuild an empty carry at the sizes
    derived from the first scan: after it the map layers hold that scan's
    voxels only, in equal counts, at the derived slot count.  The compared
    scan seeds the emptied map (no align result enters it), so the JAX
    package runs its XLA path, the cheaper one to compile on the CPU."""
    mp = pytest.MonkeyPatch()
    for k, v in KNOBS[DUALMAP].items():
        mp.setenv(k, v)
    try:
        traj, scans = sim.simulate_sequence(3, n_rings=8, n_azimuth=256)
        src = TLO.from_yaml_file(DEFAULT, env={}, device="cpu", **CAPS)
        for k in range(2):
            _feed(src, scans, traj, k)
        path = tmp_path / "previous.mm"
        src.save_local_map(path)
        env = {"MOLA_LOAD_MM": str(path)}
        jlo = _jax_lo(DEFAULT, env, auto_capacity=True)
        tlo = TLO.from_yaml_file(DEFAULT, env=env, device="cpu", auto_capacity=True)
        assert bool(tlo.carry.map_has_content[0]) and bool(jlo.carry.map_has_content)
        _compare(_feed(jlo, scans, traj, 2), _feed(tlo, scans, traj, 2), 2)
        for d in tlo.spec.map_layers:
            jm, tm = jlo.carry.maps[d.name], tlo.carry.maps[d.name]
            assert tuple(tm.data.shape) == (1, d.num_slots * tm.stride // 128, 128)
            assert tm.data.shape[1:] == jm.data.shape
            assert int((tm.count() > 0).sum()) == int((np.asarray(jm.count) > 0).sum()) > 0
        assert tlo.spec.map_layers[0].num_slots != CAPS["map_slots"]
    finally:
        mp.undo()


def test_fatal_latch_and_reset(tiny):
    tiny._fatal_error = True
    assert tiny.on_lidar_scan(np.zeros((10, 3), np.float32), 0.0) is None  # dead
    tiny.reset()
    out = tiny.on_lidar_scan(np.random.default_rng(0).uniform(-10, 10, (500, 3)).astype(np.float32), 0.0)
    assert out is not None and bool(out.processed)
    tiny._step = None
    tiny._auto_cfg = ("not a config", {})  # the next scan raises inside
    with pytest.raises(Exception):
        tiny.on_lidar_scan(np.ones((10, 3), np.float32), 1.0)
    assert tiny._fatal_error and tiny.on_lidar_scan(np.ones((10, 3), np.float32), 2.0) is None


def test_output_reaches_the_host_in_one_piece():
    from mola_lidar_odometry_tpu_torch.models.step import StepOutput

    fields = {f: torch.tensor([k], dtype=torch.float32) for k, f in enumerate(StepOutput._fields)}
    fields.update(pose_R=torch.arange(9.0).view(1, 3, 3), pose_t=torch.tensor([[1.5, -2.0, 3.25]]),
                  accepted=torch.tensor([True]), n_raw=torch.tensor([123456789], dtype=torch.int32))
    out = output_to_host(StepOutput(**fields))
    assert out.pose_R.shape == (3, 3) and out.pose_R.dtype == np.float32 and out.pose_R[2, 2] == 8.0
    assert out.accepted.dtype == np.bool_ and bool(out.accepted)
    assert out.n_raw.dtype == np.int32 and int(out.n_raw) == 123456789
    assert float(out.quality) == float(StepOutput._fields.index("quality"))


def test_entry_points_need_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        assert TLO.from_yaml_file(DEFAULT, env={}, **CAPS).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device=\"cpu\""):
            TLO.from_yaml_file(DEFAULT, env={}, **CAPS)
