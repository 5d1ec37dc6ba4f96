"""Port parity for the launcher (``apps/launcher.py``), the map converter
(``apps/convert.py``) and the viewers (``utils/viz.py``,
``utils/live_viz.py``), on the CPU (``device="cpu"``).

The launcher runs a generated launch file through ``AsyncLidarOdometry``
and gives the poses of the port's ``LidarOdometry`` fed the same frames in
process (equal: the runtime only moves the calls to its worker), and of the
JAX package's launcher on the same file within 1e-5 m.  ``convert`` goes
both ways, its MRPT files equal in decompressed bytes to the JAX package's.
The live viewer mirrors ``tests/test_live_viz.py``, and answers stats
requests while the main thread steps (it serves host copies taken between
scans, never the carry)."""

import gzip
import json
import os
import threading
import urllib.request

import numpy as np
import pytest
import torch

from mola_lidar_odometry_tpu_torch.models.odometry import LidarOdometry
from mola_lidar_odometry_tpu_torch.utils import sim
from mola_lidar_odometry_tpu_torch.utils.live_viz import LiveViewer

HERE = os.path.dirname(os.path.abspath(__file__))
PIPELINE = os.path.join(HERE, "..", "pipelines", "lidar3d-default.yaml")
TINY = dict(
    raw_capacity=1 << 12, map_slots=1 << 13,
    layer_capacities={"raw": 1 << 12, **{n: 1024 for n in (
        "decimated_for_map_raw", "decimated_for_icp_skewed", "decimated_for_icp", "decimated_for_map")}},
)
LAUNCH = """modules:
  - name: dataset
    type: SimDataset
    real_time: false
    params: {{n_frames: 4, n_rings: 8, n_azimuth: 256}}
  - name: lidar_odometry
    type: LidarOdometry
    params:
      pipeline: {pipeline}
      raw_capacity: 4096
      map_slots: 8192
      outputs:
        tum: {tum}
"""


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port steps on one torch thread (the tests run beside others)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
        return r.status, r.read()


def _tiny_lo(env=None):
    return LidarOdometry.from_yaml_file(PIPELINE, env=env or {}, device="cpu", **TINY)


def test_launcher_runs_a_launch_file_as_in_process_and_jax(tmp_path, monkeypatch):
    from mola_lidar_odometry_tpu.apps import launcher as jlauncher
    from mola_lidar_odometry_tpu_torch.apps import datasets as D, launcher

    for k in ("MOLA_TPU_PALLAS", "MOLA_TPU_PER_VOXEL_NN", "MOLA_TPU_PALLAS_CAPTURE"):
        monkeypatch.setenv(k, "1")  # the JAX package's TPU algorithm, in interpret mode
    paths = {}
    for tag in ("port", "jax"):
        paths[tag] = tmp_path / f"{tag}.tum"
        (tmp_path / f"{tag}.yaml").write_text(LAUNCH.format(pipeline=PIPELINE, tum=paths[tag]))
    lo, rt = launcher.launch(str(tmp_path / "port.yaml"), device="cpu")
    assert rt.dropped_observations == 0 and not rt.fatal_error
    assert lo.frames_processed == len(lo.trajectory) == 4
    assert jlauncher.main([str(tmp_path / "jax.yaml")]) == 0
    got, jax_rows = np.loadtxt(paths["port"]), np.loadtxt(paths["jax"])
    assert got.shape == jax_rows.shape == (4, 8)
    np.testing.assert_allclose(got[:, :4], jax_rows[:, :4], atol=1e-5, rtol=0)
    ref = LidarOdometry.from_yaml_file(PIPELINE, device="cpu", raw_capacity=4096, map_slots=8192)
    ds = D.SimDataset(4, n_rings=8, n_azimuth=256)
    for i in range(len(ds)):
        fr = ds.get(i)
        ref.on_lidar_scan(fr.xyz, fr.stamp, times=fr.times, intensity=fr.intensity, ring=fr.ring)
    ref.save_trajectory_tum(tmp_path / "ref.tum")
    assert np.array_equal(np.loadtxt(tmp_path / "ref.tum"), got)


def test_launcher_needs_a_card_unless_told_cpu(tmp_path):
    from mola_lidar_odometry_tpu_torch.apps import launcher

    (tmp_path / "l.yaml").write_text(LAUNCH.format(pipeline=PIPELINE, tum=tmp_path / "t.tum"))
    with pytest.raises(SystemExit):
        launcher.main([])  # the launch file is required
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='device="cpu"'):
            launcher.main([str(tmp_path / "l.yaml")])


def test_convert_simplemap_both_ways(tmp_path):
    from mola_lidar_odometry_tpu.apps import convert as jconvert
    from mola_lidar_odometry_tpu_torch.apps import convert
    from mola_lidar_odometry_tpu_torch.utils import serialization as S

    traj, scans = sim.simulate_sequence(2, n_rings=8, n_azimuth=256)
    lo = _tiny_lo({"MOLA_GENERATE_SIMPLEMAP": "true"})
    for k, (xyz, times, rings, valid) in enumerate(scans):
        lo.on_lidar_scan(xyz[valid], traj.stamps[k], times=times[valid])
    npz = str(tmp_path / "a.simplemap.npz")
    lo.save_simplemap(npz)
    assert convert.main([npz, str(tmp_path / "p.simplemap")]) == 0
    assert jconvert.main([npz, str(tmp_path / "j.simplemap")]) == 0
    assert gzip.open(tmp_path / "p.simplemap").read() == gzip.open(tmp_path / "j.simplemap").read()
    assert convert.main([str(tmp_path / "p.simplemap"), str(tmp_path / "back.simplemap.npz")]) == 0
    back, orig = S.load_simplemap(tmp_path / "back.simplemap.npz"), lo.reconstructed_map()
    assert len(back) == len(orig) > 0
    for a, b in zip(back, orig):
        np.testing.assert_array_equal(a.t, b.t)
        np.testing.assert_array_equal(a.scan_xyz, b.scan_xyz)


def test_convert_local_map_both_ways(tmp_path):
    from mola_lidar_odometry_tpu.apps import convert as jconvert
    from mola_lidar_odometry_tpu_torch.apps import convert
    from mola_lidar_odometry_tpu_torch.utils import serialization as S

    traj, scans = sim.simulate_sequence(2, n_rings=8, n_azimuth=256)
    lo = _tiny_lo()
    for k, (xyz, times, rings, valid) in enumerate(scans):
        lo.on_lidar_scan(xyz[valid], traj.stamps[k], times=times[valid])
    npz = str(tmp_path / "a.mm.npz")
    lo.save_local_map(npz)
    assert convert.main([npz, str(tmp_path / "p.mm"), "--device", "cpu"]) == 0
    assert jconvert.main([npz, str(tmp_path / "j.mm")]) == 0
    assert gzip.open(tmp_path / "p.mm").read() == gzip.open(tmp_path / "j.mm").read()
    pts = S.import_metric_map_mrpt(tmp_path / "p.mm")["localmap"]
    assert len(pts) == int(lo.carry.maps["localmap"].num_points()[0]) > 0
    assert convert.main([str(tmp_path / "p.mm"), str(tmp_path / "back.npz")]) == 0
    np.testing.assert_array_equal(np.load(tmp_path / "back.npz")["layer_localmap"], pts)


def test_render_snapshot_and_host_stats(tmp_path):
    from mola_lidar_odometry_tpu_torch.utils.viz import host_stats, render_snapshot

    traj, scans = sim.simulate_sequence(2, n_rings=8, n_azimuth=256)
    lo = _tiny_lo()
    for k, (xyz, times, rings, valid) in enumerate(scans):
        lo.on_lidar_scan(xyz[valid], traj.stamps[k], times=times[valid])
    st = host_stats(lo)
    c = lo.carry
    assert st["icp_quality"] == float(c.last_icp_quality[0]) and st["sigma"] == float(c.sigma[0])
    assert np.array_equal(st["pose_t"], c.pose_t[0].double().numpy()) and st["mapping"] is True
    assert st["map_voxels"] == {"localmap": int(c.maps["localmap"].num_voxels()[0])}
    assert st["map_voxels"]["localmap"] > 0
    render_snapshot(lo, tmp_path / "snap.png")
    assert (tmp_path / "snap.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def test_live_viewer_serves_run(tmp_path):
    traj, scans = sim.simulate_sequence(3, n_rings=8, n_azimuth=128)
    lo = _tiny_lo()
    viewer = LiveViewer(lo, every_n=1)
    port = viewer.start(port=0)  # any free port
    try:
        code, body = _get(port, "/")  # page + stats served before any frame
        assert code == 200 and b"live run" in body
        assert json.loads(_get(port, "/stats.json")[1])["frames"] == 0
        for k, (xyz, times, rings, valid) in enumerate(scans):
            lo.on_lidar_scan(xyz[valid], float(traj.stamps[k]), times=times[valid], ring=rings[valid])
            viewer.on_frame()
        code, body = _get(port, "/snapshot.png")
        assert code == 200 and body[:8] == b"\x89PNG\r\n\x1a\n"
        stats = json.loads(_get(port, "/stats.json")[1])
        assert stats["frames"] == 3 and stats["icp_quality"] > 0
        # controls: pause flag + queued save executed on the next frame
        assert _get(port, "/pause")[0] == 200
        assert json.loads(_get(port, "/stats.json")[1])["paused"] is True
        assert _get(port, "/resume")[0] == 200
        save_path = tmp_path / "live.mm.npz"
        assert _get(port, f"/save_map?path={save_path}")[0] == 200
        xyz, times, rings, valid = scans[0]
        lo.on_lidar_scan(xyz[valid], float(traj.stamps[-1]) + 0.1, times=times[valid], ring=rings[valid])
        viewer.on_frame()
        assert save_path.exists()
    finally:
        viewer.stop()


def test_gui_toggles_and_save_roundtrip(tmp_path):
    """Active & mapping toggles + save buttons through the enqueue_request
    path, with a save round-trip."""
    traj, scans = sim.simulate_sequence(6, n_rings=8, n_azimuth=128)
    lo = _tiny_lo()
    viewer = LiveViewer(lo, every_n=100)
    port = viewer.start(port=0)

    def feed(k):
        xyz, times, rings, valid = scans[k]
        out = lo.on_lidar_scan(xyz[valid], float(traj.stamps[k]), times=times[valid], ring=rings[valid])
        viewer.on_frame()
        return out

    try:
        feed(0)
        feed(1)
        stats = json.loads(_get(port, "/stats.json")[1])
        assert stats["active"] is True and stats["mapping"] is True
        assert "speed_mps" in stats and "hz" in stats
        assert _get(port, "/toggle_mapping")[0] == 200  # queued, applied at the next frame boundary
        feed(2)
        assert lo.mapping_enabled is False and json.loads(_get(port, "/stats.json")[1])["mapping"] is False
        pts_before = int(lo.carry.maps["localmap"].num_points()[0])
        out = feed(3)
        assert bool(out.kf_local) is False  # localization-only: no map update
        assert int(lo.carry.maps["localmap"].num_points()[0]) == pts_before
        assert _get(port, "/toggle_mapping")[0] == 200
        feed(4)
        assert lo.mapping_enabled is True
        assert _get(port, "/toggle_active")[0] == 200  # observations discarded at the module
        assert lo.active is False
        xyz, times, rings, valid = scans[5]
        assert lo.on_lidar_scan(xyz[valid], float(traj.stamps[5])) is None
        assert _get(port, "/toggle_active")[0] == 200
        assert lo.active is True
        tum = tmp_path / "live.tum"
        assert _get(port, f"/save_trajectory?path={tum}")[0] == 200
        feed(5)
        lines = tum.read_text().strip().splitlines()
        assert len([ln for ln in lines if ln and not ln.startswith("#")]) >= 4
    finally:
        viewer.stop()


def test_3d_view_endpoints():
    """/view3d (self-contained WebGL scene) + /points.json payload.  The
    map's host copy is taken only on the frames that render (every
    ``every_n``): after frame 1 of 2 the payload still holds the empty map
    of the start, after frame 2 the map."""
    traj, scans = sim.simulate_sequence(2, n_rings=8, n_azimuth=128)
    lo = _tiny_lo()
    viewer = LiveViewer(lo, every_n=2)
    port = viewer.start(port=0)
    try:
        maps = []
        for k, (xyz, times, rings, valid) in enumerate(scans):
            lo.on_lidar_scan(xyz[valid], float(traj.stamps[k]), times=times[valid], ring=rings[valid])
            viewer.on_frame()
            maps.append(len(json.loads(_get(port, "/points.json")[1])["map"]))
        assert maps[0] == 0 and int(lo.carry.maps["localmap"].num_points()[0]) > 0
        code, body = _get(port, "/view3d")
        assert code == 200 and b"webgl" in body.lower()
        assert b"http://" not in body and b"https://" not in body  # no external assets
        d = json.loads(_get(port, "/points.json")[1])
        assert len(d["map"]) % 3 == 0 and len(d["map"]) > 0
        assert len(d["traj"]) == 3 * len(lo.trajectory)
        assert len(d["pose"]) == 3 and d["zmax"] >= d["zmin"]
        assert d["pose"] == [round(float(v), 3) for v in lo.carry.pose_t[0]]
    finally:
        viewer.stop()


def test_stats_answered_while_the_main_thread_steps():
    """A stats request during a scan is answered from the last frame
    boundary's host copy: it neither waits for the step nor reads the carry
    the step is writing."""
    traj, scans = sim.simulate_sequence(3, n_rings=8, n_azimuth=256)
    lo = _tiny_lo()
    viewer = LiveViewer(lo, every_n=100)
    port = viewer.start(port=0)
    answers, stepping, done = [], threading.Event(), threading.Event()

    def poll():
        stepping.wait(10)
        while not done.is_set():
            answers.append(json.loads(_get(port, "/stats.json")[1])["frames"])

    poller = threading.Thread(target=poll, daemon=True)
    poller.start()

    def slow_step(carry, scan):  # a step the poller is sure to overlap
        stepping.set()
        out = step(carry, scan)
        while len(answers) < 3:
            threading.Event().wait(0.01)
        return out

    try:
        xyz, times, rings, valid = scans[0]
        lo.on_lidar_scan(xyz[valid], float(traj.stamps[0]), times=times[valid])
        viewer.on_frame()
        step, lo._step = lo._step, slow_step  # built at the first scan
        xyz, times, rings, valid = scans[1]
        lo.on_lidar_scan(xyz[valid], float(traj.stamps[1]), times=times[valid])
        seen = list(answers)
        viewer.on_frame()
    finally:
        done.set()
        poller.join(10)
        viewer.stop()
    assert not poller.is_alive()
    assert len(seen) >= 3 and set(seen) == {1}  # the boundary before the step
    assert json.loads(json.dumps(viewer.stats()))["frames"] == 2
