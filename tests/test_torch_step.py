"""Port parity for the slice as a whole: the lidar3d-default fleet step of
mola_lidar_odometry_tpu_torch against the JAX package's own main path.

The JAX package runs its TPU algorithm on the CPU when three switches are
set before its spec is built (per-voxel top-2 capture, the fused align, and
the Pallas capture/reselect kernels in interpret mode).  Both packages step
a B=2 fleet (two different simulated sequences) over 4 frames at the small
capacities of the verify notes; layer counts must match exactly, per-frame
poses within 5e-3, iterations within one and quality within 0.02.  Then
both start from one JAX carry (``carry_from_numpy``) and step once more."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mola_lidar_odometry_tpu_torch.models.spec import spec_from_yaml as t_spec_from_yaml
from mola_lidar_odometry_tpu_torch.parallel import batch as tpb
from mola_lidar_odometry_tpu_torch.utils import carry_io, serialization as tser, sim
from mola_lidar_odometry_tpu_torch.utils.config import load_yaml_file as t_load

HERE = os.path.dirname(os.path.abspath(__file__))
PIPE = os.path.join(HERE, "..", "pipelines", "lidar3d-default.yaml")
CAPS = {
    "raw": 1 << 15, "decimated_for_map_raw": 16384, "decimated_for_icp_skewed": 8192,
    "decimated_for_icp": 8192, "decimated_for_map": 16384,
}
SIZING = dict(raw_capacity=1 << 15, map_slots=1 << 16, layer_capacities=CAPS)
B, FRAMES = 2, 4


@pytest.fixture(scope="module")
def runs():
    mp = pytest.MonkeyPatch()
    for k in ("MOLA_TPU_PALLAS", "MOLA_TPU_PER_VOXEL_NN", "MOLA_TPU_PALLAS_CAPTURE"):
        mp.setenv(k, "1")  # read at spec build and at trace time
    try:
        from mola_lidar_odometry_tpu.models.spec import spec_from_yaml
        from mola_lidar_odometry_tpu.parallel import batch as jpb
        from mola_lidar_odometry_tpu.utils.config import load_yaml_file

        seqs = [sim.simulate_sequence(FRAMES + 1, traj_seed=s) for s in (1, 2)]
        jspec = spec_from_yaml(load_yaml_file(PIPE, env={}), **SIZING)
        assert jspec.icp_with_vel.use_pallas and jspec.icp_with_vel.per_voxel_nn
        jstep = jax.jit(jpb.make_fleet_step(jspec))
        tspec = t_spec_from_yaml(t_load(PIPE, env={}), **SIZING)
        tstep = tpb.make_fleet_step(tspec)

        def scan(k, pack, **kw):
            return pack([seqs[b][1][k] for b in range(B)], [seqs[b][0].stamps[k] for b in range(B)], **kw)

        jc, tc = jpb.init_fleet_carry(jspec, B), tpb.init_fleet_carry(tspec, B, device="cpu")
        jouts, touts = [], []
        for k in range(FRAMES):
            jc, jo = jstep(jc, scan(k, lambda s, t: jpb.pack_scans(jspec, s, t)))
            tc, to = tstep(tc, scan(k, lambda s, t: tpb.pack_scans(tspec, s, t, device="cpu")))
            jouts.append(jax.tree_util.tree_map(np.asarray, jo))
            touts.append(to)
        # one more step from an identical carry: the JAX one, carried across
        jnp_carry = jax.tree_util.tree_map(np.asarray, jc)
        tc2 = carry_io.carry_from_numpy(jnp_carry, device="cpu")
        _, jo5 = jstep(jc, scan(FRAMES, lambda s, t: jpb.pack_scans(jspec, s, t)))
        _, to5 = tstep(tc2, scan(FRAMES, lambda s, t: tpb.pack_scans(tspec, s, t, device="cpu")))
        yield dict(
            jouts=jouts, touts=touts, jo5=jax.tree_util.tree_map(np.asarray, jo5), to5=to5,
            jcarry=jnp_carry, tcarry=tc,
        )
    finally:
        mp.undo()


def _compare(jo, to):
    for f in ("n_raw", "n_icp_layer", "n_map_layer", "accepted", "kf_local"):
        np.testing.assert_array_equal(getattr(to, f).numpy(), getattr(jo, f), err_msg=f)
    np.testing.assert_allclose(to.pose_t.numpy(), jo.pose_t, atol=5e-3)
    np.testing.assert_allclose(to.pose_R.numpy(), jo.pose_R, atol=5e-3)
    assert np.all(np.abs(to.iterations.numpy() - jo.iterations) <= 1)
    np.testing.assert_allclose(to.quality.numpy(), jo.quality, atol=0.02)


def test_fleet_step_matches_jax_main_path(runs):
    for k, (jo, to) in enumerate(zip(runs["jouts"], runs["touts"])):
        _compare(jo, to)
    q = np.stack([to.quality.numpy() for to in runs["touts"]])[1:]
    assert q.mean() > 0.9
    assert int(np.stack([to.iterations.numpy() for to in runs["touts"]]).sum()) > 0


def test_step_from_shared_jax_carry_matches(runs):
    _compare(runs["jo5"], runs["to5"])


def test_carry_io_round_trips_and_tracks_jax(runs):
    jc, tc = runs["jcarry"], runs["tcarry"]
    back = carry_io.carry_to_numpy(carry_io.carry_from_numpy(jc, device="cpu"))
    np.testing.assert_array_equal(back.maps["localmap"].data, jc.maps["localmap"].data)
    np.testing.assert_array_equal(back.nav.times, jc.nav.times)
    np.testing.assert_array_equal(back.lm_kfs.t, jc.lm_kfs.t)
    port = carry_io.carry_to_numpy(tc)
    for f in ("frame_idx", "traj_len", "removal_counter", "map_has_content"):
        np.testing.assert_array_equal(getattr(port, f), getattr(jc, f), err_msg=f)
    np.testing.assert_array_equal(port.maps["localmap"].epoch, jc.maps["localmap"].epoch)
    np.testing.assert_allclose(port.sigma, jc.sigma, rtol=0.05)
    # the tables were built from deskewed points on both sides: float
    # rounding may move a rare point across a voxel or offset cell, so
    # they agree in all but a tiny fraction of words
    same = np.mean(port.maps["localmap"].data == jc.maps["localmap"].data)
    assert same > 0.999, same


@pytest.mark.parametrize(
    "env",
    [
        {"MOLA_LIDAR_COUNT": "2"}, {"MOLA_SAVE_TRAJECTORY": "true"}, {"MOLA_SAVE_DEBUG_TRACES": "true"},
        {"MOLA_START_ACTIVE": "false"}, {"MOLA_LOAD_MM": "prior.mm"}, {"MOLA_LOAD_SM": "prior.simplemap"},
        {"MOLA_GENERATE_SIMPLEMAP": "true"}, {"MP2P_ICP_GENERATE_DEBUG_FILES": "1"},
    ],
)
def test_spec_rejects_host_only_options(env, tmp_path, monkeypatch):
    """The reference's host-side options take effect through the port's
    ``LidarOdometry`` and ``AsyncLidarOdometry``, as in the JAX package; the
    ICP debug logs, whose replay is not ported, raise instead of being
    ignored."""
    from mola_lidar_odometry_tpu_torch.models.odometry import LidarOdometry
    from mola_lidar_odometry_tpu_torch.utils.runtime import AsyncLidarOdometry, Observation

    monkeypatch.chdir(tmp_path)
    traj, scans = sim.simulate_sequence(3, n_rings=8, n_azimuth=256)

    def feed(lo, k):
        xyz, times, rings, valid = scans[k]
        return lo.on_lidar_scan(xyz[valid], traj.stamps[k], times=times[valid], ring=rings[valid])

    if "MP2P_ICP_GENERATE_DEBUG_FILES" in env:
        monkeypatch.setenv("MP2P_ICP_GENERATE_DEBUG_FILES", "1")
        with pytest.raises(NotImplementedError, match="replay_align_with_trace"):
            LidarOdometry.from_yaml_file(PIPE, env={}, device="cpu", **SIZING)
        return
    if "MOLA_LOAD_MM" in env or "MOLA_LOAD_SM" in env:  # a previous session's outputs
        prev = LidarOdometry.from_yaml_file(PIPE, env={"MOLA_GENERATE_SIMPLEMAP": "true"}, device="cpu", **SIZING)
        feed(prev, 0)
        prev.save_local_map("prior.mm")
        prev.save_simplemap("prior.simplemap")
    env = dict(env, MOLA_TUM_TRAJECTORY_OUTPUT="traj.tum", MOLA_DEBUG_TRACES_FILE="traces.csv",
               MOLA_SIMPLEMAP_OUTPUT="final.simplemap", MOLA_SIMPLEMAP_GENERATE_LAZY_LOAD="true")
    assert t_spec_from_yaml(t_load(PIPE, env={}), **SIZING).start_active
    lo = LidarOdometry.from_yaml_file(PIPE, env=env, device="cpu", **SIZING)
    if "MOLA_LIDAR_COUNT" in env:
        assert lo.spec.multiple_lidar_count == 2
        rt = AsyncLidarOdometry(lo)
        xyz, times, _, valid = scans[0]
        half = int(valid.sum()) // 2
        rt.on_new_observation(Observation("lidar", "lidar", 0.0, {"xyz": xyz[valid][:half], "times": times[valid][:half]}))
        rt.worker.wait_all()
        assert lo.frames_processed == 0  # waiting for the second sensor
        rt.on_new_observation(Observation("lidar", "/ouster/points", 0.01, {"xyz": xyz[valid][half:], "times": times[valid][half:]}))
        rt.shutdown()
        assert lo.frames_processed == 1 and not rt.fatal_error
        return
    if "MOLA_START_ACTIVE" in env:
        assert not lo.active and feed(lo, 0) is None and lo.frames_processed == 0
        return
    if "MOLA_LOAD_MM" in env:
        np.testing.assert_array_equal(lo.carry.maps["localmap"].data, prev.carry.maps["localmap"].data)
        assert bool(lo.carry.map_has_content[0])
        return
    if "MOLA_LOAD_SM" in env:
        assert len(lo.simplemap) == len(prev.simplemap) == 1
        return
    for k in range(2):
        assert bool(feed(lo, k).accepted)
    lo.close()
    if "MOLA_SAVE_TRAJECTORY" in env:
        assert np.loadtxt("traj.tum").shape == (2, 8)
    if "MOLA_SAVE_DEBUG_TRACES" in env:
        assert len(open("traces.csv").read().splitlines()) == 3
    if "MOLA_GENERATE_SIMPLEMAP" in env:
        back = tser.load_simplemap("final.simplemap")
        assert len(back) == len(lo.simplemap) >= 1 and back[0].scan_path is not None
        assert (tmp_path / "final.simplemap_Images").is_dir()
