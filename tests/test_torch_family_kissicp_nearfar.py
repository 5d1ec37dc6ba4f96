"""Port parity of the two shipped pipeline families the port ran but no
test stepped: lidar3d-kissicp-like (one point-to-point matcher, the fused
path on kernels B1-B3's plain twins) and lidar3d-near-far (two matchers,
near and far layers, the generic loop on kernel B4's plain twin), stepped
through the JAX package's ``LidarOdometry`` and the port's over 6 simulated
frames with the gate of ``test_torch_family_ndt.step_both``, auto-sized
from the first scan.  They mirror ``tests/test_oracle_parity.py``'s
``test_kissicp_family_parity`` (2.0 m/s) and ``test_nearfar_family_perpose``
(0.5 m/s) regimes against the JAX package.  For kissicp-like the JAX
package runs its TPU algorithm on the CPU (the Pallas kernels in interpret
mode), as ``tests/test_torch_step.py`` does."""

import pytest

from test_torch_family_ndt import GENERIC, step_both

FUSED = {"MOLA_TPU_PALLAS": "1", "MOLA_TPU_PER_VOXEL_NN": "1", "MOLA_TPU_PALLAS_CAPTURE": "1"}


def test_kissicp_family_matches_jax():
    from mola_lidar_odometry_tpu_torch.ops import icp as ticp

    _, _, jouts, touts, jlo, tlo = step_both("extras/lidar3d-kissicp-like.yaml", FUSED,
                                             scan_kw=dict(n_rings=16, n_azimuth=512))
    assert ticp._fused_eligible(tlo.spec.icp_with_vel)
    assert tlo.spec.layer_capacities == jlo.spec.layer_capacities
    assert all(bool(o.accepted) for o in touts) and min(float(o.quality) for o in touts[1:]) > 0.8


def test_nearfar_family_matches_jax():
    """The regime of ``test_nearfar_family_perpose`` (0.5 m/s, where the
    configuration tracks; at 2 m/s its own GT tracking is ill-conditioned on
    this world, the oracle parity tests' docstrings say)."""
    _, _, jouts, touts, jlo, tlo = step_both("extras/lidar3d-near-far.yaml", GENERIC,
                                             scan_kw=dict(n_rings=16, n_azimuth=512, speed=0.5))
    assert len(tlo.spec.icp_with_vel.matchers) == 3 and tlo.spec.icp_with_vel.nn_neighbors == 27
    assert tlo.spec.layer_capacities == jlo.spec.layer_capacities
    assert all(bool(o.accepted) for o in touts)
