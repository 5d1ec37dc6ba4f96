"""Port parity: capacity auto-sizing with insert budgets
(``utils/capacity.py``, ``with_budgets=True``) against the JAX package's, on
the scan and specs of ``test_torch_capacity.py``."""

import pytest

from mola_lidar_odometry_tpu_torch.utils import capacity as tcap
from test_torch_capacity import PIPES, _specs, scan  # noqa: F401 (the fixture)


@pytest.mark.parametrize("name", sorted(PIPES))
@pytest.mark.parametrize("known_max_points", [None, 12345])
@pytest.mark.parametrize("with_budgets", [True])
def test_derive_capacities_equals_jax(scan, name, known_max_points, with_budgets):  # noqa: F811
    from mola_lidar_odometry_tpu.utils import capacity as jcap

    ts, js = _specs(name)
    got = tcap.derive_capacities(ts, *scan, with_budgets=with_budgets, known_max_points=known_max_points)
    want = jcap.derive_capacities(js, *scan, with_budgets=with_budgets, known_max_points=known_max_points)
    assert got == want
    assert len(got) == (4 if with_budgets else 3)
