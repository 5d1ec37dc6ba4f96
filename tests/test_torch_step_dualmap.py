"""Port parity for the second slice as a whole: the fleet step of
``pipelines/extras/lidar3d-dual-map.yaml`` (two point matchers, two
hashed-voxel maps with K=20 and K=10, 27 probes, the generic align loop) in
mola_lidar_odometry_tpu_torch against the JAX package's step.

The JAX package runs with ``MOLA_TPU_PER_VOXEL_NN=1`` (the capture view the
port always uses) and ``MOLA_TPU_PALLAS=0`` (the XLA twin of its
``nn_select`` kernel; tests/test_torch_match.py holds the port's select
against the Pallas kernel itself).  Both step a B=2 fleet (two simulated
sequences) over 4 frames at tiny capacities: layer counts and the
accepted/keyframe flags must match exactly, poses within 5e-3, iterations
within one, quality within 0.02, and after the first insert both map tables
must be equal word for word.  Then both start from one shared JAX carry
(two map layers of different K through ``carry_io``) and step once more."""

import os

import jax
import numpy as np
import pytest
import torch

from mola_lidar_odometry_tpu_torch.models.spec import spec_from_yaml as t_spec_from_yaml
from mola_lidar_odometry_tpu_torch.parallel import batch as tpb
from mola_lidar_odometry_tpu_torch.utils import carry_io, sim
from mola_lidar_odometry_tpu_torch.utils.config import load_yaml_file as t_load

HERE = os.path.dirname(os.path.abspath(__file__))
PIPE = os.path.join(HERE, "..", "pipelines", "extras", "lidar3d-dual-map.yaml")
CAPS = {
    "raw": 1 << 15, "decimated_for_map_raw": 8192, "decimated_for_map_skewed": 8192,
    "decimated_for_map": 8192, "decimated_for_icp_skewed": 4096, "decimated_for_icp": 4096,
    "decimated_for_icp_near_skewed": 6144, "decimated_for_icp_near": 6144,
}
SIZING = dict(raw_capacity=1 << 15, map_slots=1 << 15, layer_capacities=CAPS)
B, FRAMES = 2, 4
MAPS = ("localmap", "localmap_far")


@pytest.fixture(scope="module")
def runs():
    mp = pytest.MonkeyPatch()
    mp.setenv("MOLA_TPU_PER_VOXEL_NN", "1")  # read when the JAX spec is built
    mp.setenv("MOLA_TPU_PALLAS", "0")
    try:
        from mola_lidar_odometry_tpu.models.spec import spec_from_yaml
        from mola_lidar_odometry_tpu.parallel import batch as jpb
        from mola_lidar_odometry_tpu.utils.config import load_yaml_file

        seqs = [sim.simulate_sequence(FRAMES + 1, traj_seed=s) for s in (1, 2)]
        jspec = spec_from_yaml(load_yaml_file(PIPE, env={}), **SIZING)
        assert jspec.icp_with_vel.per_voxel_nn and not jspec.icp_with_vel.use_pallas
        jstep = jax.jit(jpb.make_fleet_step(jspec))
        tspec = t_spec_from_yaml(t_load(PIPE, env={}), **SIZING)
        tstep = tpb.make_fleet_step(tspec)

        def scan(k, pack, **kw):
            return pack([seqs[b][1][k] for b in range(B)], [seqs[b][0].stamps[k] for b in range(B)], **kw)

        jc, tc = jpb.init_fleet_carry(jspec, B), tpb.init_fleet_carry(tspec, B, device="cpu")
        jouts, touts, tables0 = [], [], None
        for k in range(FRAMES):
            jc, jo = jstep(jc, scan(k, lambda s, t: jpb.pack_scans(jspec, s, t)))
            tc, to = tstep(tc, scan(k, lambda s, t: tpb.pack_scans(tspec, s, t, device="cpu")))
            jouts.append(jax.tree_util.tree_map(np.asarray, jo))
            touts.append(to)
            if k == 0:  # the port updates its tables in place: copy now
                tables0 = {n: (np.asarray(jc.maps[n].data), tc.maps[n].data.numpy().copy()) for n in MAPS}
        jnp_carry = jax.tree_util.tree_map(np.asarray, jc)
        tc2 = carry_io.carry_from_numpy(jnp_carry, device="cpu")
        _, jo5 = jstep(jc, scan(FRAMES, lambda s, t: jpb.pack_scans(jspec, s, t)))
        _, to5 = tstep(tc2, scan(FRAMES, lambda s, t: tpb.pack_scans(tspec, s, t, device="cpu")))
        yield dict(
            jouts=jouts, touts=touts, jo5=jax.tree_util.tree_map(np.asarray, jo5), to5=to5, jspec=jspec,
            tspec=tspec, jcarry=jnp_carry, tcarry=tc, tcarry2=tc2, tables0=tables0,
        )
    finally:
        mp.undo()


def _compare(jo, to):
    for f in ("n_raw", "n_icp_layer", "n_map_layer", "accepted", "kf_local", "corrections",
              "map_collision_drops", "map_full_drops", "deferred_drops"):
        np.testing.assert_array_equal(getattr(to, f).numpy(), getattr(jo, f), err_msg=f)
    np.testing.assert_allclose(to.pose_t.numpy(), jo.pose_t, atol=5e-3)
    np.testing.assert_allclose(to.pose_R.numpy(), jo.pose_R, atol=5e-3)
    assert np.all(np.abs(to.iterations.numpy() - jo.iterations) <= 1)
    np.testing.assert_allclose(to.quality.numpy(), jo.quality, atol=0.02)


def test_dualmap_spec_matches_jax(runs):
    """Two map generators, two FilterMerge inserts, the multi-matcher probe
    footprint and per-map insert budgets load as in the JAX package."""
    js, ts = runs["jspec"], runs["tspec"]
    assert [d.name for d in ts.map_layers] == list(MAPS)
    for jd, td in zip(js.map_layers, ts.map_layers):
        assert (jd.name, jd.points_per_voxel, jd.insert_budget, jd.num_slots) == (
            td.name, td.points_per_voxel, td.insert_budget, td.num_slots)
    assert [(o.input_layer, o.target_map_layer) for o in ts.map_inserts] == [
        (o.input_layer, o.target_map_layer) for o in js.map_inserts]
    ji, ti = js.icp_with_vel, ts.icp_with_vel
    assert ti.nn_neighbors == ji.nn_neighbors == 27 and len(ti.matchers) == 2
    for jm, tm in zip(ji.matchers, ti.matchers):
        assert (jm.local_layer, jm.global_layer, jm.weight) == (tm.local_layer, tm.global_layer, tm.weight)
    assert (ti.hook_min_trans, ti.hook_min_rot) == (ji.hook_min_trans, ji.hook_min_rot)
    assert ts.icp_local_layer == js.icp_local_layer == "decimated_for_icp"


def test_dualmap_fleet_step_matches_jax(runs):
    for jo, to in zip(runs["jouts"], runs["touts"]):
        _compare(jo, to)
    q = np.stack([to.quality.numpy() for to in runs["touts"]])[1:]
    assert q.mean() > 0.9
    its = np.stack([to.iterations.numpy() for to in runs["touts"]])
    assert its[1:].min() > 0
    for k, to in enumerate(runs["touts"]):
        assert int(to.n_icp_layer.max()) < CAPS["decimated_for_icp"]
        assert int(to.n_map_layer.max()) < CAPS["decimated_for_map"]


def test_dualmap_tables_equal_after_first_insert(runs):
    """Frame 0 has no twist, so both packages insert the same points: both
    tables (K=20 and K=10) must be equal word for word."""
    for name in MAPS:
        jt, tt = runs["tables0"][name]
        assert (tt != 0).sum() > 10000
        np.testing.assert_array_equal(tt, jt, err_msg=name)


def test_dualmap_step_from_shared_jax_carry_matches(runs):
    tc2, jc = runs["tcarry2"], runs["jcarry"]
    assert (tc2.maps["localmap"].K, tc2.maps["localmap_far"].K) == (20, 10)
    assert tc2.maps["localmap_far"].stride == int(jc.maps["localmap_far"].stride)
    _compare(runs["jo5"], runs["to5"])


def test_dualmap_carry_tracks_jax(runs):
    jc, port = runs["jcarry"], carry_io.carry_to_numpy(runs["tcarry"])
    for f in ("frame_idx", "traj_len", "removal_counter", "map_has_content"):
        np.testing.assert_array_equal(getattr(port, f), getattr(jc, f), err_msg=f)
    for name in MAPS:
        np.testing.assert_array_equal(port.maps[name].epoch, jc.maps[name].epoch)
        # later frames insert deskewed points: float rounding may move a rare
        # point across a voxel or offset cell
        same = np.mean(port.maps[name].data == jc.maps[name].data)
        assert same > 0.999, (name, same)


def test_dualmap_twist_correction_rounds_match_jax(monkeypatch):
    """The shipped frames never stop on the twist hook, so the correction
    rounds are forced with a 4 mm hook (the simulated vehicle starts slowly): every round must re-deskew all three
    Deskew outputs (both ICP layers and the map layer) and re-enter the
    generic loop with the remaining budget, as the JAX package does."""
    monkeypatch.setenv("MOLA_TPU_PER_VOXEL_NN", "1")
    monkeypatch.setenv("MOLA_TPU_PALLAS", "0")
    from mola_lidar_odometry_tpu.models.spec import spec_from_yaml
    from mola_lidar_odometry_tpu.parallel import batch as jpb
    from mola_lidar_odometry_tpu.utils.config import load_yaml_file
    from mola_lidar_odometry_tpu_torch.models.filter_graph import deskew_ops

    def cfg(load):
        c = load(PIPE, env={})
        c["params"]["optimize_twist_rerun_min_trans"] = 0.004
        return c

    frames = 4
    seqs = [sim.simulate_sequence(frames, traj_seed=s, speed=6.0) for s in (3, 4)]
    jspec, tspec = spec_from_yaml(cfg(load_yaml_file), **SIZING), t_spec_from_yaml(cfg(t_load), **SIZING)
    assert sorted(op.output for op in deskew_ops(tspec.filter2)) == [
        "decimated_for_icp", "decimated_for_icp_near", "decimated_for_map"]
    jstep, tstep = jax.jit(jpb.make_fleet_step(jspec)), tpb.make_fleet_step(tspec)
    jc, tc = jpb.init_fleet_carry(jspec, B), tpb.init_fleet_carry(tspec, B, device="cpu")
    total_corr = 0
    for k in range(frames):
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
