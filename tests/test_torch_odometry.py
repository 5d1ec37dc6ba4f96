"""Port parity for the host API: ``LidarOdometry`` of
mola_lidar_odometry_tpu_torch (``device="cpu"``) against the JAX package's.
(``test_torch_odometry_host.py`` holds the rest of the host surface.)

The JAX package runs its TPU algorithm on the CPU (``MOLA_TPU_PALLAS=1
MOLA_TPU_PER_VOXEL_NN=1 MOLA_TPU_PALLAS_CAPTURE=1``, the Pallas kernels in
interpret mode) for lidar3d-default, and ``MOLA_TPU_PER_VOXEL_NN=1
MOLA_TPU_PALLAS=0`` for lidar3d-dual-map (the XLA twin of its nearest-select
kernel), as the step parity tests do.  Both step the same simulated frames
(seeded): per frame the accepted and keyframe flags and the layer counts
must match exactly, poses within 5e-3 and quality within 0.02, and the
trajectory stamps are equal in float64.  A layer count that differs at
frame 0 names, for both packages, the raw bounding radius, the point that
gives it and a hash of the raw scan buffer the step read (ROADMAP C3).
Then auto-sizing, ``pin_se2`` auto, the GNSS/IMU buffers, the fatal latch
and ``reset``, simple-maps read both ways, and the ICP debug logs."""

import hashlib
import os

import numpy as np
import pytest
import torch

from mola_lidar_odometry_tpu_torch.models.odometry import LidarOdometry as TLO, output_to_host
from mola_lidar_odometry_tpu_torch.utils import serialization as tser, sim

HERE = os.path.dirname(os.path.abspath(__file__))
DEFAULT = os.path.join(HERE, "..", "pipelines", "lidar3d-default.yaml")
DUALMAP = os.path.join(HERE, "..", "pipelines", "extras", "lidar3d-dual-map.yaml")
CAPS = dict(  # the small capacities of the verify notes
    raw_capacity=1 << 15, map_slots=1 << 16,
    layer_capacities={"raw": 1 << 15, "decimated_for_map_raw": 16384, "decimated_for_icp_skewed": 8192,
                      "decimated_for_icp": 8192, "decimated_for_map": 16384},
)
KNOBS = {
    DEFAULT: {"MOLA_TPU_PALLAS": "1", "MOLA_TPU_PER_VOXEL_NN": "1", "MOLA_TPU_PALLAS_CAPTURE": "1"},
    DUALMAP: {"MOLA_TPU_PALLAS": "0", "MOLA_TPU_PER_VOXEL_NN": "1"},
}
FRAMES = 5
FLAGS = ("processed", "accepted", "kf_local", "kf_simplemap", "sm_insert", "n_raw", "n_icp_layer", "n_map_layer",
         "corrections")


def _jax_lo(pipe, env, **kw):
    from mola_lidar_odometry_tpu.models.odometry import LidarOdometry

    return LidarOdometry.from_yaml_file(pipe, env=env, **kw)


def _feed(lo, scans, traj, k, **kw):
    xyz, times, rings, valid = scans[k]
    return lo.on_lidar_scan(xyz[valid], traj.stamps[k], times=times[valid], ring=rings[valid], **kw)


def _compare(jo, to, k, note=""):
    for f in FLAGS:
        np.testing.assert_array_equal(getattr(to, f), np.asarray(getattr(jo, f)), err_msg=f"{f} frame {k}{note}")
    np.testing.assert_allclose(to.pose_t, np.asarray(jo.pose_t), atol=5e-3)
    np.testing.assert_allclose(to.pose_R, np.asarray(jo.pose_R), atol=5e-3)
    np.testing.assert_allclose(float(to.quality), float(jo.quality), atol=0.02)


def _raw_probe(tag, scan, out) -> str:
    """The frame-0 raw evidence of one package (ROADMAP C3): the step's
    estimated range (the raw bounding radius at frame 0), the radius of the
    scan buffer the step read recomputed on the host, the index and
    coordinates of the point that gives it, and a sha1 of that buffer."""
    xyz = np.asarray(scan.xyz, np.float32).reshape(-1, 3)
    valid = np.asarray(scan.valid, bool).reshape(-1)
    r = np.where(valid, np.sqrt(np.sum(xyz * xyz, axis=1)), np.float32(0.0))
    i = int(np.argmax(r))
    sha = hashlib.sha1(xyz.tobytes() + valid.tobytes()).hexdigest()
    return (f"\n{tag}: step est_range {float(np.asarray(out.est_range).reshape(-1)[0])!r}, raw bounding radius "
            f"{float(r[i])!r} at point {i} {xyz[i].tolist()}, sha1 of the raw buffer {sha}")


def _feed_probed(tag, lo, scans, traj, k):
    """``_feed`` with the scan the step read kept, and its probe."""
    kept = []
    pad = lo._pad_scan
    lo._pad_scan = lambda *a, **kw: kept.append(pad(*a, **kw)) or kept[-1]
    try:
        out = _feed(lo, scans, traj, k)
    finally:
        del lo._pad_scan
    return out, _raw_probe(tag, kept[0], out)


def _run_both(pipe, frames, env, scans_kw, gnss=False, **caps):
    mp = pytest.MonkeyPatch()
    for k, v in KNOBS[pipe].items():
        mp.setenv(k, v)  # read when the JAX spec is built and traced
    try:
        traj, scans = sim.simulate_sequence(frames, **scans_kw)
        jlo, tlo = _jax_lo(pipe, env, **caps), TLO.from_yaml_file(pipe, env=env, device="cpu", **caps)
        jouts, touts, probe = [], [], ""
        for k in range(frames):
            for lo in (jlo, tlo):
                if gnss:  # a fix 0.2 s before every scan
                    lo.on_gnss(traj.stamps[k] - 0.2, {"enu": traj.t[k].tolist()})
                lo.on_imu(traj.stamps[k], {"wz": 0.1 * k})
            if k == 0:
                (jo, jp), (to, tp) = _feed_probed("JAX", jlo, scans, traj, k), _feed_probed("port", tlo, scans, traj, k)
                jouts.append(jo)
                touts.append(to)
                probe = jp + tp
                continue
            jouts.append(_feed(jlo, scans, traj, k))
            touts.append(_feed(tlo, scans, traj, k))
        return dict(traj=traj, scans=scans, jlo=jlo, tlo=tlo, jouts=jouts, touts=touts, probe=probe)
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def fixed():
    """lidar3d-default at the verify capacities, simple-map on, GNSS fed."""
    return _run_both(DEFAULT, FRAMES, {"MOLA_GENERATE_SIMPLEMAP": "true"}, {}, gnss=True, **CAPS)


def test_frames_match_jax(fixed):
    for k, (jo, to) in enumerate(zip(fixed["jouts"], fixed["touts"])):
        _compare(jo, to, k, note=fixed["probe"] if k == 0 else "")
        assert to.pose_R.shape == (3, 3) and to.n_raw.shape == ()
    assert sum(bool(o.accepted) for o in fixed["touts"]) == FRAMES
    jt, tt = fixed["jlo"].estimated_trajectory(), fixed["tlo"].estimated_trajectory()
    assert tt["stamps"].dtype == np.float64 and np.array_equal(tt["stamps"], jt["stamps"])
    np.testing.assert_allclose(tt["t"], jt["t"], atol=5e-3)
    np.testing.assert_allclose(np.abs(tt["quat_xyzw"]), np.abs(jt["quat_xyzw"]), atol=5e-3)


def test_simplemap_and_gnss_buffers_match_jax(fixed):
    jsm, tsm = fixed["jlo"].reconstructed_map(), fixed["tlo"].reconstructed_map()
    assert len(tsm) == len(jsm) > 1
    for j, t in zip(jsm, tsm):
        assert t.stamp == j.stamp
        assert (t.scan_xyz is None) == (j.scan_xyz is None)
        assert t.gnss == j.gnss and t.gnss is not None
        assert t.metadata == j.metadata
    assert len(fixed["tlo"]._imu_buffer) == FRAMES and len(fixed["tlo"]._gnss_buffer) == FRAMES


def test_simplemap_round_trips_both_ways(fixed, tmp_path):
    from mola_lidar_odometry_tpu.utils import serialization as jser

    for save, load, lo in ((tser.save_simplemap, jser.load_simplemap, fixed["tlo"]),
                           (jser.save_simplemap, tser.load_simplemap, fixed["jlo"])):
        for lazy in (False, True):
            path = tmp_path / f"{save.__module__.split('.')[0]}_{lazy}.simplemap"
            save(path, lo.reconstructed_map(), lazy_load=lazy)
            back = load(path)
            assert len(back) == len(lo.reconstructed_map())
            for a, b in zip(back, lo.reconstructed_map()):
                assert a.stamp == b.stamp and a.gnss == b.gnss
                np.testing.assert_array_equal(a.t, b.t)
                np.testing.assert_array_equal(a.quat_xyzw, b.quat_xyzw)
                if b.scan_xyz is None:
                    assert a.scan_xyz is None
                else:
                    np.testing.assert_array_equal(a.scan_xyz, b.scan_xyz.astype(np.float32))
                assert (a.scan_path is not None) == (lazy and b.scan_xyz is not None)


@pytest.mark.parametrize("pipe", [DEFAULT, DUALMAP], ids=["default", "dual-map"])
def test_auto_sizing_matches_jax(pipe):
    """No capacity given: both size every buffer from the first scan (the
    same integers), then step the same frames."""
    r = _run_both(pipe, 4, {}, dict(n_rings=32, n_azimuth=1024))
    js, ts = r["jlo"].spec, r["tlo"].spec
    assert ts.raw_capacity == js.raw_capacity == 40960
    assert ts.layer_capacities == js.layer_capacities
    assert [(d.name, d.num_slots, d.insert_budget) for d in ts.map_layers] == [
        (d.name, d.num_slots, d.insert_budget) for d in js.map_layers]
    assert ts.pin_se2 is False and js.pin_se2 is False
    for k, (jo, to) in enumerate(zip(r["jouts"], r["touts"])):
        _compare(jo, to, k)
    assert np.array_equal(r["tlo"].estimated_trajectory()["stamps"], r["jlo"].estimated_trajectory()["stamps"])
    assert tuple(r["tlo"].carry.maps[ts.map_layers[0].name].data.shape) == (1, ts.map_layers[0].num_slots // 4, 128)


def test_pin_se2_auto_resolves_from_a_planar_scan():
    rng = np.random.default_rng(1)
    planar = np.c_[rng.uniform(-20, 20, (3000, 2)), np.zeros(3000)].astype(np.float32)
    for xyz, want in ((planar, True), (planar + np.float32([0, 0, 0.3]), False)):
        jlo, tlo = _jax_lo(DEFAULT, {}, **CAPS), TLO.from_yaml_file(DEFAULT, env={}, device="cpu", **CAPS)
        assert tlo.spec.pin_se2 is None and tlo._step is None
        jlo._ensure_step(xyz)
        tlo._ensure_step(xyz)
        assert tlo.spec.pin_se2 is want and jlo.spec.pin_se2 is want
    out = tlo.on_lidar_scan(planar, 5.0)
    assert bool(out.processed) and bool(out.accepted)


@pytest.fixture
def tiny():
    return TLO.from_yaml_file(DEFAULT, env={}, device="cpu", **CAPS)


def test_fatal_latch_and_reset(tiny):
    tiny._fatal_error = True
    assert tiny.on_lidar_scan(np.zeros((10, 3), np.float32), 0.0) is None  # dead
    tiny.reset()
    out = tiny.on_lidar_scan(np.random.default_rng(0).uniform(-10, 10, (500, 3)).astype(np.float32), 0.0)
    assert out is not None and bool(out.processed)
    tiny._step = None
    tiny._auto_cfg = ("not a config", {})  # the next scan raises inside
    with pytest.raises(Exception):
        tiny.on_lidar_scan(np.ones((10, 3), np.float32), 1.0)
    assert tiny._fatal_error and tiny.on_lidar_scan(np.ones((10, 3), np.float32), 2.0) is None


def test_output_reaches_the_host_in_one_piece():
    from mola_lidar_odometry_tpu_torch.models.step import StepOutput

    fields = {f: torch.tensor([k], dtype=torch.float32) for k, f in enumerate(StepOutput._fields)}
    fields.update(pose_R=torch.arange(9.0).view(1, 3, 3), pose_t=torch.tensor([[1.5, -2.0, 3.25]]),
                  accepted=torch.tensor([True]), n_raw=torch.tensor([123456789], dtype=torch.int32))
    out = output_to_host(StepOutput(**fields))
    assert out.pose_R.shape == (3, 3) and out.pose_R.dtype == np.float32 and out.pose_R[2, 2] == 8.0
    assert out.accepted.dtype == np.bool_ and bool(out.accepted)
    assert out.n_raw.dtype == np.int32 and int(out.n_raw) == 123456789
    assert float(out.quality) == float(StepOutput._fields.index("quality"))


def test_entry_points_need_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        assert TLO.from_yaml_file(DEFAULT, env={}, **CAPS).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device=\"cpu\""):
            TLO.from_yaml_file(DEFAULT, env={}, **CAPS)


def test_debug_files_env_writes_icp_logs(tmp_path, monkeypatch):
    """``MP2P_ICP_GENERATE_DEBUG_FILES=1`` (the reference's switch) writes
    one ``.icplog.npz`` per ``MP2P_ICP_LOG_FILES_DECIMATION``-th frame into
    ``icp-logs/``; the frames step as without it."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("MP2P_ICP_GENERATE_DEBUG_FILES", "1")
    monkeypatch.setenv("MP2P_ICP_LOG_FILES_DECIMATION", "2")
    traj, scans = sim.simulate_sequence(3, n_rings=8, n_azimuth=256)
    lo = TLO.from_yaml_file(DEFAULT, env={}, device="cpu", **CAPS)
    outs = [_feed(lo, scans, traj, k) for k in range(3)]
    assert all(bool(o.accepted) for o in outs)
    assert sorted(os.listdir("icp-logs")) == ["icp-run-000000.icplog.npz", "icp-run-000002.icplog.npz"]
    log = np.load("icp-logs/icp-run-000002.icplog.npz")
    assert log["poses_R"].shape == (30, 3, 3) and int(log["iterations"]) == 30 and log["paired"].max() > 0
    monkeypatch.delenv("MP2P_ICP_GENERATE_DEBUG_FILES")
    plain = TLO.from_yaml_file(DEFAULT, env={}, device="cpu", **CAPS)
    for k, o in enumerate(outs):
        p = _feed(plain, scans, traj, k)
        np.testing.assert_array_equal(p.pose_t, o.pose_t)
        assert int(p.iterations) == int(o.iterations)

