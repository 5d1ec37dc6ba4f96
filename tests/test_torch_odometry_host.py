"""Port parity for the host API, continued from ``test_torch_odometry.py``
(the same helpers): wheel odometry, relocalization, the mapping toggle,
publisher callbacks, the local map's point view, a local map saved by one
package stepped by the other, and auto-sizing over a preloaded map."""

import numpy as np
import pytest
import torch

from mola_lidar_odometry_tpu_torch.models.odometry import LidarOdometry as TLO
from mola_lidar_odometry_tpu_torch.utils import sim
from test_torch_odometry import CAPS, DEFAULT, DUALMAP, KNOBS, _compare, _feed, _jax_lo


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
