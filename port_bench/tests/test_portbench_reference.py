"""The plain reference against the port's float64 oracle, of which it is a
frozen copy (CPU): the same YAML and scans give the same poses, qualities,
iterations, map-update decisions and layer counts."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from port_bench.gen import raycast, world  # noqa: E402
from port_bench.reference import oracle, pipeline  # noqa: E402


@pytest.fixture(scope="module")
def sequence():
    traffic = json.loads((ROOT / "port_bench" / "traffic" / "fleet64-drive.json").read_text())
    tr = dict(traffic, instances=1, frames=6)
    wd, trajs, drives = world.fleet(21, tr)
    frames, _ = raycast.fleet_scans(wd, trajs, dict(traffic["sensor"], rings=32, azimuths=512),
                                    world.noise_seeds(21, tr, drives), "cpu")
    scans = [(f[0][0][f[3][0]].double().numpy(), f[1][0][f[3][0]].double().numpy()) for f in frames]
    return scans, [float(np.float32(k / 10.0)) for k in range(len(scans))]


@pytest.mark.parametrize("config", ["lidar3d-default", "lidar3d-dual-map"])
def test_reference_follows_the_port_oracle(sequence, config):
    from mola_lidar_odometry_tpu_torch.models.spec import spec_from_yaml
    from mola_lidar_odometry_tpu_torch.oracle import OracleOdometry
    from mola_lidar_odometry_tpu_torch.utils.config import load_yaml_file

    torch.set_num_threads(1)
    yaml_path = ROOT / "port_bench" / "configs" / f"{config}.yaml"
    scans, stamps = sequence
    ref = oracle.run_sequence(str(yaml_path), scans, stamps)
    port = OracleOdometry(spec_from_yaml(load_yaml_file(yaml_path, env={})))
    for (x, t), s, r in zip(scans, stamps, ref):
        o = port.step(x, t, s)
        np.testing.assert_allclose(r.t, o.t, atol=1e-6)
        np.testing.assert_allclose(r.R, o.R, atol=1e-7)
        assert r.quality == pytest.approx(o.quality, abs=1e-9)
        assert (r.iterations, r.accepted, r.kf_local) == (o.iterations, o.accepted, o.kf_local)
    assert sum(r.iterations for r in ref) > 5 and all(r.n_icp_layer > 100 for r in ref)


def test_pipeline_reading_matches_the_port_spec():
    """The reference reads the YAML's expressions and settings as the port's
    spec does (expressions to float32 rounding)."""
    from mola_lidar_odometry_tpu_torch.models.spec import spec_from_yaml
    from mola_lidar_odometry_tpu_torch.utils.config import load_yaml_file

    for config in ("lidar3d-default", "lidar3d-dual-map"):
        path = ROOT / "port_bench" / "configs" / f"{config}.yaml"
        p, s = pipeline.read(path), spec_from_yaml(load_yaml_file(path, env={}))
        env = dict(ESTIMATED_SENSOR_MAX_RANGE=63.0, INSTANTANEOUS_SENSOR_MAX_RANGE=41.0, ADAPTIVE_THRESHOLD_SIGMA=1.3,
                   ICP_ITERATION=7.0, wx=0.01, wy=-0.02, wz=0.3, vx=5.0, vy=0.0, vz=0.1)
        assert [m.local_layer for m in p.icp.matchers] == [m.local_layer for m in s.icp_with_vel.matchers]
        for a, b in zip(p.icp.matchers, s.icp_with_vel.matchers):
            assert a.threshold(env) == pytest.approx(float(b.threshold(env)), rel=1e-6)
        assert p.icp.kernel_param(env) == pytest.approx(float(s.icp_with_vel.kernel_param(env)), rel=1e-6)
        assert (p.icp.max_iterations, p.icp.hook_min_trans) == (s.icp_with_vel.max_iterations,
                                                                s.icp_with_vel.hook_min_trans)
        for a, b in zip(p.map_layers, s.map_layers):
            assert (a.name, a.points_per_voxel) == (b.name, b.points_per_voxel)
            assert a.voxel_size(env) == pytest.approx(float(b.voxel_size(env)), rel=1e-6)
        lmu, lms = p.local_map_updates, s.local_map_updates
        assert lmu.min_translation_between_keyframes(env) == pytest.approx(
            float(lms.min_translation_between_keyframes(env)), rel=1e-6)
        assert [type(op).__name__ for op in p.filter1 + p.filter2] == [type(op).__name__ for op in s.filter1 + s.filter2]
