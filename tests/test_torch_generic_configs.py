"""Port parity for the generic ICP loop's configuration: every shipped
pipeline that takes the generic loop builds the same ``IcpConfig`` in the
port as in the JAX package (``models/spec.py::_icp_from_yaml``)."""

import pytest

from mola_lidar_odometry_tpu_torch.ops import icp as ticp


@pytest.mark.parametrize(
    "rel",
    ["extras/lidar3d-dual-map.yaml", "extras/lidar3d-near-far.yaml", "lidar2d.yaml",
     "extras/icp-pipeline_no_motion_model.yaml", "lidar3d-ndt.yaml", "extras/lidar3d-intensity.yaml",
     "extras/lidar3d-edges.yaml"],
)
def test_shipped_generic_loop_configs_build(rel):
    """Every shipped pipeline that takes the generic loop builds the same
    ``IcpConfig`` in the port as in the JAX package (several matchers, two
    pairings per point, the Horn stage), and none is fused-eligible."""
    import os

    from mola_lidar_odometry_tpu.models import spec as jspec
    from mola_lidar_odometry_tpu.utils.config import load_yaml_file as jload
    from mola_lidar_odometry_tpu_torch.models import spec as tspec
    from mola_lidar_odometry_tpu_torch.utils.config import load_yaml_file as tload

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "pipelines", rel)
    jc, tc = jload(path, env={}), tload(path, env={})
    jblock, tblock = jc.get("icp_settings_with_vel", jc), tc.get("icp_settings_with_vel", tc)
    hook = (0.15, 0.0131)
    (ji, jl), (ti, tl) = jspec._icp_from_yaml(jblock, hook), tspec._icp_from_yaml(tblock, hook)
    assert jl == tl and len(ji.matchers) == len(ti.matchers)
    for f in ("max_iterations", "min_abs_step_trans", "min_abs_step_rot", "gn_inner_iterations", "nn_neighbors",
              "hook_min_trans", "hook_min_rot"):
        assert getattr(ji, f) == getattr(ti, f), f
    assert (ji.horn is None) == (ti.horn is None)
    if ti.horn is not None:
        assert ti.horn == ticp.HornCfg(ji.horn.run_until_translation_correction_smaller_than)
    for jm, tm in zip(ji.matchers, ti.matchers):
        for f in ("kind", "local_layer", "global_layer", "threshold_angular_deg", "pairings_per_point", "weight",
                  "run_from_iteration", "run_up_to_iteration", "allow_match_already_matched"):
            assert getattr(jm, f) == getattr(tm, f), f
    assert not ticp._fused_eligible(ti)
    if "settings" in "".join(tc):  # a whole pipeline, not a bare ICP block
        tspec.spec_from_yaml(tc)
