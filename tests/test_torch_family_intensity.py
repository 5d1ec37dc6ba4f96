"""Port parity of the lidar3d-intensity family
(``pipelines/extras/lidar3d-intensity.yaml``: intensity normalization and
selection, two point-to-point matchers on two hashed-voxel maps, the
generic loop on kernel B4's plain twin), stepped through the JAX package's
``LidarOdometry`` and the port's over 6 simulated frames, with the gate of
``test_torch_family_ndt.step_both``.  The capacities are explicit: the
capacity derivation has no rule for the intensity filters and raises in
both packages.  Intensities are ``sim.world_intensity``, a function of the
world position, so bright points stay bright from frame to frame."""

import os

import pytest

from mola_lidar_odometry_tpu_torch.utils import sim
from test_torch_family_ndt import GENERIC, PIPELINES, step_both

REL = "extras/lidar3d-intensity.yaml"
CAPS = dict(
    raw_capacity=1 << 13, map_slots=1 << 14,
    layer_capacities={"raw": 1 << 13, "decimated_for_map_raw": 4096, "decimated_for_map_by_range": 4096,
                      "decimated_for_map": 4096, "decimated_for_map_bright": 4096, "decimated_for_icp": 2048},
)


def test_intensity_family_matches_jax():
    _, _, jouts, touts, jlo, tlo = step_both(REL, GENERIC, intensity=sim.world_intensity,
                                             scan_kw=dict(n_rings=16, n_azimuth=512), **CAPS)
    assert sorted(tlo.carry.maps) == ["localmap", "localmap_bright"]
    bright = tlo.carry.maps["localmap_bright"]
    assert int((bright.count() > 0).sum()) > 50  # the bright layer was mapped and matched against
    assert all(bool(o.accepted) for o in touts) and min(float(o.quality) for o in touts[1:]) > 0.5


def test_intensity_family_needs_explicit_sizes():
    """Auto-sizing raises on the intensity filters in both packages."""
    from mola_lidar_odometry_tpu.models.odometry import LidarOdometry as JLO
    from mola_lidar_odometry_tpu_torch.models.odometry import LidarOdometry as TLO

    traj, scans = sim.simulate_sequence(1, n_rings=8, n_azimuth=256)
    xyz, times, rings, valid = scans[0]
    for lo in (JLO.from_yaml_file(os.path.join(PIPELINES, REL), env={}),
               TLO.from_yaml_file(os.path.join(PIPELINES, REL), env={}, device="cpu")):
        with pytest.raises(ValueError):
            lo._ensure_step(xyz[valid], times[valid])
