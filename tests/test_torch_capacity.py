"""Port parity: capacity auto-sizing (``utils/capacity.py``) against the JAX
package's ``utils/capacity.py``.  The sizes are integers and must be equal.
One simulated scan (seeded) feeds both packages.  The sizing with insert
budgets is in ``test_torch_capacity_budgets.py``, the float64 filter-graph
interpreter it runs (``utils/exact_filters.py``) in
``test_torch_exact_filters.py``."""

import os

import pytest

from mola_lidar_odometry_tpu_torch.models.spec import spec_from_yaml as t_spec
from mola_lidar_odometry_tpu_torch.utils import capacity as tcap, sim
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
@pytest.mark.parametrize("with_budgets", [False])  # with budgets: test_torch_capacity_budgets.py
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
