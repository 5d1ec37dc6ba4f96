"""The port's float64 oracle (``mola_lidar_odometry_tpu_torch/oracle.py``)
against the JAX package's (``mola_lidar_odometry_tpu/oracle.py``), built
from the same YAML, overrides and scans, on seven pipeline families: 4
frames each of lidar3d-default, lidar3d-ndt, lidar2d, lidar3d-dual-map,
lidar3d-kissicp-like, lidar3d-near-far and rgbd at the sizes of the JAX
package's ``tests/test_oracle_parity.py`` (its scans cut to 16 x 512 rays).

Both oracles are numpy in float64 through the same operations in the same
order, reading their own package's compiled spec, so every pose must match
to 1e-12 and every exact map (point lists, NDT moments, occupancy log-odds)
must hold the same voxels with equal contents."""

import os

import numpy as np
import pytest

from mola_lidar_odometry_tpu.models.spec import spec_from_yaml as jspec_from_yaml
from mola_lidar_odometry_tpu.oracle import OracleOdometry as JOracle
from mola_lidar_odometry_tpu_torch.models.spec import spec_from_yaml as tspec_from_yaml
from mola_lidar_odometry_tpu_torch.oracle import OracleOdometry as TOracle
from mola_lidar_odometry_tpu_torch.utils import sim
from mola_lidar_odometry_tpu_torch.utils.config import load_yaml_file

from test_oracle_parity import _DUAL_CAPS, _NEARFAR_CAPS, TEST_OVERRIDES, _extras_overrides

HERE = os.path.dirname(os.path.abspath(__file__))
PIPELINES = os.path.join(HERE, "..", "pipelines")
FRAMES = 4
POSE_TOL = 1e-12

_LIDAR2D = dict(raw_capacity=1 << 11, map_slots=1 << 16, kf_ring_capacity=128,
                layer_capacities={"raw": 1 << 11, "deskewed": 1 << 11, "decimated_pre": 1 << 11, "decimated": 1 << 11})
_NDT = _extras_overrides(dict(decimated_for_map_by_range=16384, decimated_for_map_skewed=16384))
_KISS = _extras_overrides(dict(decimated_for_map_skewed=16384, filtered=16384, deskewed=1 << 15))
_RGBD = _extras_overrides(dict(edges=16384, planes=1 << 15, edges_for_map=8192, edges_for_icp=8192,
                               planes_for_map=16384, planes_for_icp=8192))

FAMILIES = {  # name: (pipeline, overrides, scan keywords)
    "lidar3d-default": ("lidar3d-default.yaml", TEST_OVERRIDES, dict(speed=2.0)),
    "lidar3d-ndt": ("lidar3d-ndt.yaml", _NDT, dict(speed=2.0)),
    "lidar2d": ("lidar2d.yaml", _LIDAR2D, None),
    "dual-map": ("extras/lidar3d-dual-map.yaml", _extras_overrides(_DUAL_CAPS), dict(speed=2.0)),
    "kissicp-like": ("extras/lidar3d-kissicp-like.yaml", _KISS, dict(speed=2.0)),
    "near-far": ("extras/lidar3d-near-far.yaml", _extras_overrides(_NEARFAR_CAPS), dict(speed=0.5, noise=0.005)),
    "rgbd": ("rgbd.yaml", _RGBD, dict(speed=2.0)),
}


def _scans(scan_kw):
    if scan_kw is None:  # test_lidar2d_family_parity's world, trajectory and planar sensor
        world = sim.make_world(3, extent=25.0, n_boxes=40, n_plates=30)
        traj = sim.make_trajectory(FRAMES, dt=0.1, seed=4, speed=1.5, z=0.3)
        return traj, [sim.simulate_scan(world, traj.R[k], traj.t[k], traj.twists[k], n_rings=1, n_azimuth=720,
                                        fov_up_deg=0.0, fov_down_deg=0.0, spin_period=0.1, max_range=30.0,
                                        seed=50 + k) for k in range(FRAMES)]
    return sim.simulate_sequence(FRAMES, dt=0.1, noise=scan_kw.pop("noise", 0.01), n_rings=16, n_azimuth=512,
                                 **scan_kw)


def _contents(m):
    """An exact map's voxels in insertion order, each as one float64 vector."""
    out = []
    for k, v in m.vox.items():
        parts = v if isinstance(v, list) else [v]
        out.append((k, np.concatenate([np.ravel(np.asarray(x, np.float64)) for x in parts])))
    return out


@pytest.mark.parametrize("family", list(FAMILIES))
def test_port_oracle_equals_jax_oracle(family):
    rel, overrides, scan_kw = FAMILIES[family]
    cfg_path = os.path.join(PIPELINES, rel)
    traj, scans = _scans(dict(scan_kw) if scan_kw is not None else None)
    tor = TOracle(tspec_from_yaml(load_yaml_file(cfg_path, env={}), **overrides))
    jor = JOracle(jspec_from_yaml(load_yaml_file(cfg_path, env={}), **overrides))
    for k, (xyz, times, rings, valid) in enumerate(scans):
        args = (xyz[valid].astype(np.float64), times[valid].astype(np.float64), float(traj.stamps[k]))
        to, jo = tor.step(*args, ring=rings[valid]), jor.step(*args, ring=rings[valid])
        np.testing.assert_allclose(to.R, jo.R, rtol=0, atol=POSE_TOL, err_msg=f"{family} frame {k}")
        np.testing.assert_allclose(to.t, jo.t, rtol=0, atol=POSE_TOL, err_msg=f"{family} frame {k}")
        assert (to.iterations, to.accepted, to.kf_local) == (jo.iterations, jo.accepted, jo.kf_local)
        assert abs(to.quality - jo.quality) <= 1e-12
    assert sorted(tor.maps) == sorted(jor.maps) and tor.maps
    for name in tor.maps:
        assert type(tor.maps[name]).__name__ == type(jor.maps[name]).__name__
        tc, jc = _contents(tor.maps[name]), _contents(jor.maps[name])
        assert [k for k, _ in tc] == [k for k, _ in jc], name
        for (key, a), (_, b) in zip(tc, jc):
            np.testing.assert_array_equal(a, b, err_msg=f"{family} {name} {key}")
    assert all(o.accepted for o in tor.outputs[1:]) or family == "near-far"
