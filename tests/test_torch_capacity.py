"""Port parity: capacity auto-sizing (``utils/capacity.py``) and the float64
filter-graph interpreter it runs (``utils/exact_filters.py``) against the
JAX package's ``utils/capacity.py`` and ``oracle.apply_pipeline_exact``.

The sizes are integers and must be equal; the interpreter's layers must hold
the same points.  One simulated scan (seeded) feeds both packages."""

import os

import numpy as np
import pytest

from mola_lidar_odometry_tpu_torch.models.spec import spec_from_yaml as t_spec
from mola_lidar_odometry_tpu_torch.utils import capacity as tcap, exact_filters, sim
from mola_lidar_odometry_tpu_torch.utils.config import load_yaml_file as t_load

HERE = os.path.dirname(os.path.abspath(__file__))
PIPES = {
    "default": os.path.join(HERE, "..", "pipelines", "lidar3d-default.yaml"),
    "dual-map": os.path.join(HERE, "..", "pipelines", "extras", "lidar3d-dual-map.yaml"),
    "ndt": os.path.join(HERE, "..", "pipelines", "lidar3d-ndt.yaml"),
}


@pytest.fixture(scope="module")
def scan():
    traj, scans = sim.simulate_sequence(2, n_rings=16, n_azimuth=512, traj_seed=3)
    xyz, times, _, valid = scans[1]
    return xyz[valid], times[valid]


def _specs(name):
    from mola_lidar_odometry_tpu.models.spec import spec_from_yaml
    from mola_lidar_odometry_tpu.utils.config import load_yaml_file

    return t_spec(t_load(PIPES[name], env={})), spec_from_yaml(load_yaml_file(PIPES[name], env={}))


@pytest.mark.parametrize("name", sorted(PIPES))
@pytest.mark.parametrize("known_max_points", [None, 12345])
@pytest.mark.parametrize("with_budgets", [False, True])
def test_derive_capacities_equals_jax(scan, name, known_max_points, with_budgets):
    from mola_lidar_odometry_tpu.utils import capacity as jcap

    ts, js = _specs(name)
    got = tcap.derive_capacities(ts, *scan, with_budgets=with_budgets, known_max_points=known_max_points)
    want = jcap.derive_capacities(js, *scan, with_budgets=with_budgets, known_max_points=known_max_points)
    assert got == want
    assert len(got) == (4 if with_budgets else 3)


def test_sizing_constants_equal_jax():
    from mola_lidar_odometry_tpu.utils import capacity as jcap

    for k in ("LAYER_MARGIN", "LAYER_QUANTUM", "BUDGET_MARGIN", "RAW_QUANTUM", "MAP_SLOTS_FACTOR",
              "MAP_SLOTS_MIN", "MAP_SLOTS_MAX"):
        assert getattr(tcap, k) == getattr(jcap, k), k


@pytest.mark.parametrize("name", sorted(PIPES))
def test_exact_filters_equal_oracle(scan, name):
    """The port's interpreter keeps the oracle's points in every layer, on
    a twist that makes the deskew move them."""
    from mola_lidar_odometry_tpu import oracle

    ts, js = _specs(name)
    xyz, times = (np.asarray(a, np.float64) for a in scan)
    env = {k: 0.0 for k in ("vx", "vy", "vz", "wx", "wy", "wz", "robot_x", "robot_y", "robot_z", "robot_yaw",
                            "robot_pitch", "robot_roll", "ICP_ITERATION", "icp_iterations", "SENSOR_TIME_OFFSET",
                            "twistCorrectionCount", "current_relative_timestamp")}
    env.update(vx=6.0, wz=0.3, ADAPTIVE_THRESHOLD_SIGMA=2.0, ESTIMATED_SENSOR_MAX_RANGE=60.0,
               INSTANTANEOUS_SENSOR_MAX_RANGE=60.0)
    tl, jl = {"raw": exact_filters.Cloud(xyz, times)}, {"raw": oracle.Cloud(xyz, times)}
    for tp, jp in ((ts.adjust_pipeline, js.adjust_pipeline), (ts.filter1, js.filter1), (ts.filter2, js.filter2)):
        tl = exact_filters.apply_pipeline_exact(tp, tl, env)
        jl = oracle.apply_pipeline_exact(jp, jl, env)
    assert sorted(tl) == sorted(jl) and len(tl) > 4
    for k in tl:
        assert len(tl[k].xyz) == len(jl[k].xyz) > 0, k
        np.testing.assert_array_equal(tl[k].xyz, jl[k].xyz, err_msg=k)
        np.testing.assert_array_equal(tl[k].time, jl[k].time, err_msg=k)


def test_exact_filters_reject_an_unknown_op():
    with pytest.raises(ValueError, match="unsupported pipeline op"):
        exact_filters.apply_pipeline_exact([object()], {}, {})


def test_closest_to_average_equals_oracle():
    from mola_lidar_odometry_tpu import oracle

    rng = np.random.default_rng(4)
    pts, times = rng.uniform(-5, 5, (3000, 3)), rng.uniform(0, 0.1, 3000)
    got = exact_filters._decimate_closest_to_average(pts, times, 0.7)
    want = oracle._decimate_closest_to_average(pts, times, 0.7)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
