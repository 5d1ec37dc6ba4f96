"""Port parity of the lidar3d-edges family
(``pipelines/extras/lidar3d-edges.yaml``: the curvature filter along each
ring, one point-to-point matcher with two layer rows, large- and
small-curvature, on two hashed-voxel maps, the generic loop on kernel B4's
plain twin), stepped through the JAX package's ``LidarOdometry`` and the
port's over 6 simulated ring-ordered frames, with the gate of
``test_torch_family_ndt.step_both``.  The capacities are explicit: the
capacity derivation has no rule for the curvature filter and raises in
both packages (the sizes here hold the layers' populations on these scans
with room: at most 73 large-curvature points, 2447 and 1628 in the
small-curvature map and ICP layers)."""

import os

import pytest

from test_torch_family_ndt import GENERIC, PIPELINES, step_both

REL = "extras/lidar3d-edges.yaml"
CAPS = dict(
    raw_capacity=1 << 13, map_slots=1 << 14,
    layer_capacities={"raw": 1 << 13, "deskewed": 1 << 13, "range_filtered": 1 << 13, "large_curvature": 1 << 13,
                      "smaller_curvature": 1 << 13, "decimated_for_map_large_curvature": 256,
                      "decimated_for_icp_large_curvature": 256, "decimated_for_map_smaller_curvature": 4096,
                      "decimated_for_icp_smaller_curvature": 2048},
)


def test_edges_family_matches_jax():
    _, _, jouts, touts, jlo, tlo = step_both(REL, GENERIC, scan_kw=dict(n_rings=16, n_azimuth=512), **CAPS)
    assert sorted(tlo.carry.maps) == ["localmap_large_curvature", "localmap_small_curvature"]
    large = tlo.carry.maps["localmap_large_curvature"]
    assert int((large.count() > 0).sum()) > 20  # edge points were mapped and matched against
    assert len(tlo.spec.icp_with_vel.matchers) == 2
    assert all(bool(o.accepted) for o in touts) and min(float(o.quality) for o in touts[1:]) > 0.5


def test_edges_family_needs_explicit_sizes():
    """Auto-sizing raises on the curvature filter in both packages (the sizes here hold the layers' populations on these scans
with room: at most 73 large-curvature points, 2447 and 1628 in the
small-curvature map and ICP layers)."""
    from mola_lidar_odometry_tpu.models.odometry import LidarOdometry as JLO
    from mola_lidar_odometry_tpu_torch.models.odometry import LidarOdometry as TLO
    from mola_lidar_odometry_tpu_torch.utils import sim

    traj, scans = sim.simulate_sequence(1, n_rings=8, n_azimuth=256)
    xyz, times, rings, valid = scans[0]
    for lo in (JLO.from_yaml_file(os.path.join(PIPELINES, REL), env={}),
               TLO.from_yaml_file(os.path.join(PIPELINES, REL), env={}, device="cpu")):
        with pytest.raises(ValueError):
            lo._ensure_step(xyz[valid], times[valid])
