"""Port parity for the twist re-optimization rounds of the step.

The bench frames never stop on the twist hook, so the correction loop of
``models/step.py`` (re-deskew with the corrected twist, re-align with the
remaining budget, per-instance masking of finished instances) is forced
here: both packages read a YAML whose ``optimize_twist_rerun_min_trans`` is
2 cm instead of 15 cm.  The JAX package runs its TPU path (Pallas in
interpret mode).  Correction counts and layer counts must match exactly;
poses within 5e-3 and quality within 0.02; iterations within one per align
(``corrections + 1`` aligns per frame)."""

import os

import jax
import numpy as np
import pytest

from mola_lidar_odometry_tpu_torch.models.spec import spec_from_yaml as t_spec_from_yaml
from mola_lidar_odometry_tpu_torch.parallel import batch as tpb
from mola_lidar_odometry_tpu_torch.utils import sim
from mola_lidar_odometry_tpu_torch.utils.config import load_yaml_file as t_load

HERE = os.path.dirname(os.path.abspath(__file__))
PIPE = os.path.join(HERE, "..", "pipelines", "lidar3d-default.yaml")
CAPS = {
    "raw": 1 << 15, "decimated_for_map_raw": 8192, "decimated_for_icp_skewed": 4096,
    "decimated_for_icp": 4096, "decimated_for_map": 8192,
}
SIZING = dict(raw_capacity=1 << 15, map_slots=1 << 15, layer_capacities=CAPS)
B, FRAMES = 2, 4


def _cfg(load):
    cfg = load(PIPE, env={})
    cfg["params"]["optimize_twist_rerun_min_trans"] = 0.02
    return cfg


def test_twist_correction_rounds_match_jax(monkeypatch):
    for k in ("MOLA_TPU_PALLAS", "MOLA_TPU_PER_VOXEL_NN", "MOLA_TPU_PALLAS_CAPTURE"):
        monkeypatch.setenv(k, "1")
    from mola_lidar_odometry_tpu.models.spec import spec_from_yaml
    from mola_lidar_odometry_tpu.parallel import batch as jpb
    from mola_lidar_odometry_tpu.utils.config import load_yaml_file

    seqs = [sim.simulate_sequence(FRAMES, traj_seed=s, speed=6.0) for s in (3, 4)]
    jspec = spec_from_yaml(_cfg(load_yaml_file), **SIZING)
    tspec = t_spec_from_yaml(_cfg(t_load), **SIZING)
    assert jspec.icp_with_vel.hook_min_trans == tspec.icp_with_vel.hook_min_trans == 0.02
    jstep = jax.jit(jpb.make_fleet_step(jspec))
    tstep = tpb.make_fleet_step(tspec)
    jc, tc = jpb.init_fleet_carry(jspec, B), tpb.init_fleet_carry(tspec, B, device="cpu")
    total_corr = 0
    for k in range(FRAMES):
        scans = [seqs[b][1][k] for b in range(B)]
        stamps = [seqs[b][0].stamps[k] for b in range(B)]
        jc, jo = jstep(jc, jpb.pack_scans(jspec, scans, stamps))
        tc, to = tstep(tc, tpb.pack_scans(tspec, scans, stamps, device="cpu"))
        jo = jax.tree_util.tree_map(np.asarray, jo)
        for f in ("corrections", "n_icp_layer", "n_map_layer", "accepted"):
            np.testing.assert_array_equal(getattr(to, f).numpy(), getattr(jo, f), err_msg=f"{f} frame {k}")
        np.testing.assert_allclose(to.pose_t.numpy(), jo.pose_t, atol=5e-3)
        np.testing.assert_allclose(to.pose_R.numpy(), jo.pose_R, atol=5e-3)
        np.testing.assert_allclose(to.quality.numpy(), jo.quality, atol=0.02)
        assert np.all(np.abs(to.iterations.numpy() - jo.iterations) <= jo.corrections + 1)
        total_corr += int(jo.corrections.sum())
    assert total_corr > 0  # the correction rounds really ran
