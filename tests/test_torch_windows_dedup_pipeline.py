"""Port parity of lidar3d-default with a 256-lane point map and the dedup:
``max_points_per_voxel: 200`` (a window spanning two rows) and
``min_distance_between_points: 0.2``, stepped 4 frames through both
packages' ``LidarOdometry`` at the family gate of
``test_torch_family_ndt.step_both``, on the generic loop: the JAX package
with ``MOLA_TPU_PALLAS=0`` (the XLA twin of its nearest-select kernel, as
the other generic-loop families), the port with ``fused_align=False`` (the
plain twin of kernel B4).  The port's default at this depth, the fused
align on the plain capture, is held in ``test_torch_fused_dispatch.py``."""

from test_torch_family_ndt import GENERIC, step_both
from test_torch_voxel_hash_windows import yaml_copy


def test_deep_voxels_with_dedup_match_jax(tmp_path):
    from mola_lidar_odometry_tpu_torch.ops import icp as ticp

    _, _, _, touts, jlo, tlo = step_both(yaml_copy(tmp_path, 200, 0.2), GENERIC, frames=4,
                                         scan_kw=dict(n_rings=16, n_azimuth=512), port_knobs=dict(fused_align=False))
    m = tlo.carry.maps["localmap"]
    # the configuration alone would take the fused path; fused_align off keeps it on the generic loop
    assert (m.K, m.stride) == (200, 256) and ticp._fused_eligible(tlo.spec.icp_with_vel)
    assert not tlo.spec.icp_with_vel.fused_align
    assert tlo.spec.map_layers[0].min_distance_between_points == 0.2
    assert tlo.spec.layer_capacities == jlo.spec.layer_capacities
    assert all(bool(o.accepted) for o in touts)
