"""Port parity: the float64 filter-graph interpreter capacity auto-sizing
runs (``utils/exact_filters.py``) against the JAX package's
``oracle.apply_pipeline_exact``: the interpreter's layers must hold the same
points.  The scan and specs are ``test_torch_capacity.py``'s."""

import numpy as np
import pytest

from mola_lidar_odometry_tpu_torch.utils import exact_filters
from test_torch_capacity import PIPES, _specs, scan  # noqa: F401 (the fixture)


@pytest.mark.parametrize("name", sorted(PIPES))
def test_exact_filters_equal_oracle(scan, name):  # noqa: F811
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
