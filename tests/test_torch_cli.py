"""Port parity for the offline CLI (``apps/cli.py``) and the slice as a
whole: the cases of ``tests/test_cli.py`` on the port's CLI with
``--device cpu`` (simulator and KITTI-layout inputs, multi-session resume,
localization-only, the icp-log viewer), the port's capacities derived
from the first scan when none is pinned, and both packages' CLIs over the
same ``--input-sim 4`` run at small capacities: TUM poses within 1e-5 m and
1e-5 rad, simple-map keyframe counts and stamps exact, the local maps' live
point counts exact.  The JAX package runs its TPU algorithm on the CPU there
(``MOLA_TPU_PALLAS=1 MOLA_TPU_PER_VOXEL_NN=1 MOLA_TPU_PALLAS_CAPTURE=1``, its
kernels in interpret mode), as the odometry parity test does."""

import os

import numpy as np
import pytest
import torch

from mola_lidar_odometry_tpu_torch.apps.cli import main
from mola_lidar_odometry_tpu_torch.utils import serialization as S

PIPELINE = os.path.join(os.path.dirname(__file__), "..", "pipelines", "lidar3d-default.yaml")
SMALL = ["--raw-capacity", "16384", "--map-slots", "32768", "-v", "ERROR"]
CPU = ["--device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port steps on one torch thread (the tests run beside others)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_cli_sim_run(tmp_path):
    out_tum, out_sm, out_mm = (str(tmp_path / n) for n in ("out.tum", "out.simplemap.npz", "out.mm.npz"))
    rc = main(["-c", PIPELINE, "--input-sim", "6", "--output-tum-path", out_tum, "--output-simplemap", out_sm,
               "--output-local-map", out_mm] + SMALL + CPU)
    assert rc == 0
    assert np.loadtxt(out_tum).shape == (6, 8)  # 6 poses, 8 columns
    assert np.loadtxt(out_tum + ".gt.tum").shape[0] == 6  # GT exported next to it
    maps = S.load_metric_map(out_mm, device="cpu")
    assert "localmap" in maps and int(maps["localmap"].num_points()[0]) > 0
    kfs = S.load_simplemap(out_sm)
    assert len(kfs) >= 1 and kfs[0].scan_xyz is not None and kfs[0].scan_xyz.shape[1] == 3


def test_auto_capacity_sizes_as_lidar_odometry(tmp_path):
    """With no capacity pinned the port's CLI derives every buffer and the
    insert budget from the first scan: the sizes and poses of
    ``LidarOdometry.from_yaml_file`` auto-sizing itself on the same frames."""
    from mola_lidar_odometry_tpu_torch.apps import cli
    from mola_lidar_odometry_tpu_torch.apps.datasets import SimDataset
    from mola_lidar_odometry_tpu_torch.models.odometry import LidarOdometry

    lo = cli.run(["-c", PIPELINE, "--input-sim", "3", "-v", "ERROR"] + CPU)
    ref = LidarOdometry.from_yaml_file(PIPELINE, device="cpu")
    ds = SimDataset(3)
    for i in range(len(ds)):
        fr = ds.get(i)
        ref.on_lidar_scan(fr.xyz, fr.stamp, times=fr.times, intensity=fr.intensity, ring=fr.ring)
    for spec in (lo.spec, ref.spec):
        assert spec.raw_capacity < 1 << 17 and spec.map_layers[0].insert_budget > 0
    assert lo.spec.layer_capacities == ref.spec.layer_capacities and lo.spec.raw_capacity == ref.spec.raw_capacity
    assert [(d.name, d.num_slots, d.insert_budget) for d in lo.spec.map_layers] == [
        (d.name, d.num_slots, d.insert_budget) for d in ref.spec.map_layers]
    a, b = lo.estimated_trajectory(), ref.estimated_trajectory()
    assert np.array_equal(a["t"], b["t"]) and np.array_equal(a["quat_xyzw"], b["quat_xyzw"]) and len(a["t"]) == 3


def test_cli_rejects_multiple_inputs():
    with pytest.raises(SystemExit):
        main(["-c", PIPELINE, "--input-sim", "2", "--input-paris-luco"] + CPU)


def test_cli_requires_one_input():
    with pytest.raises(SystemExit):
        main(["-c", PIPELINE] + CPU)


def test_cli_needs_a_card_unless_told_cpu():
    """``--device`` defaults to the card; without one the CLI raises before
    it steps (it never carries on on the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device runs")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        main(["-c", PIPELINE, "--input-sim", "1"] + SMALL)


def test_multisession_resume(tmp_path):
    """Save the local map, reload it into a fresh engine (multi-session)."""
    from mola_lidar_odometry_tpu_torch.models.odometry import LidarOdometry

    out_mm = str(tmp_path / "session1.mm.npz")
    main(["-c", PIPELINE, "--input-sim", "3", "--output-local-map", out_mm] + SMALL + CPU)
    lo = LidarOdometry.from_yaml_file(PIPELINE, device="cpu", raw_capacity=16384, map_slots=32768)
    lo.load_local_map(out_mm)
    assert int(lo.carry.maps["localmap"].num_points()[0]) > 0


def test_metric_map_roundtrip_without_npz_extension(tmp_path):
    """save('map.mm') + load('map.mm') agree though np.savez appends '.npz'."""
    from mola_lidar_odometry_tpu_torch.ops.pointcloud import PointCloud
    from mola_lidar_odometry_tpu_torch.ops.voxel_hash import VoxelHashMap, insert_stats

    m = VoxelHashMap.create(1 << 8, 4, 0.5, 1, "cpu")
    m, _ = insert_stats(m, PointCloud.from_xyz(torch.tensor([[[0.1, 0.2, 0.3], [5.0, 5.0, 5.0]]])))
    path = str(tmp_path / "session.mm")  # no .npz
    S.save_metric_map(path, {"localmap": m})
    maps = S.load_metric_map(path, device="cpu")
    assert int(maps["localmap"].num_points()[0]) == int(m.num_points()[0]) == 2


def test_localization_only_mode(tmp_path, monkeypatch):
    """Mapping disabled + preloaded map = localization-only session
    (reference MOLA_MAPPING_ENABLED / load_existing_local_map)."""
    from mola_lidar_odometry_tpu_torch.models.odometry import LidarOdometry
    from mola_lidar_odometry_tpu_torch.utils import sim

    overrides = dict(raw_capacity=16384, map_slots=32768, layer_capacities={
        "raw": 16384, "decimated_for_map_raw": 8192, "decimated_for_icp_skewed": 4096, "decimated_for_icp": 4096,
        "decimated_for_map": 8192})
    traj, scans = sim.simulate_sequence(6, n_rings=16, n_azimuth=512)
    lo1 = LidarOdometry.from_yaml_file(PIPELINE, device="cpu", **overrides)
    for k, (xyz, times, rings, valid) in enumerate(scans[:4]):
        lo1.on_lidar_scan(xyz[valid], traj.stamps[k], times=times[valid])
    mm = str(tmp_path / "session.mm.npz")
    lo1.save_local_map(mm)
    monkeypatch.setenv("MOLA_MAPPING_ENABLED", "false")
    lo2 = LidarOdometry.from_yaml_file(PIPELINE, device="cpu", **overrides)
    monkeypatch.delenv("MOLA_MAPPING_ENABLED")
    assert not lo2.spec.local_map_updates.enabled
    lo2.load_local_map(mm)
    n_before = int(lo2.carry.maps["localmap"].num_points()[0])
    outs = [lo2.on_lidar_scan(xyz[valid], traj.stamps[4 + k], times=times[valid])
            for k, (xyz, times, rings, valid) in enumerate(scans[4:6])]
    assert int(lo2.carry.maps["localmap"].num_points()[0]) == n_before  # no inserts
    assert all(bool(o.accepted) for o in outs)


def test_icplog_viewer(tmp_path):
    from mola_lidar_odometry_tpu.apps.icplog_viewer import summarize as jsummarize
    from mola_lidar_odometry_tpu_torch.apps.icplog_viewer import main as viewer_main, summarize
    from mola_lidar_odometry_tpu_torch.utils.icp_log import IcpLogWriter

    w = IcpLogWriter(directory=str(tmp_path), decimation=1)
    assert w.want_frame()
    p = w.log(frame_idx=0, stamp=1.5, poses_R=np.broadcast_to(np.eye(3), (5, 3, 3)),
              poses_t=np.cumsum(np.full((5, 3), 0.1), axis=0), paired=np.asarray([100, 120, 130, 131, 131]),
              quality=0.9, iterations=5)
    assert summarize(str(p)) == jsummarize(str(p))
    out = str(tmp_path / "view.png")
    assert viewer_main([str(p), "-o", out]) == 0 and (tmp_path / "view.png").exists()


def test_cli_kitti_layout_end_to_end(tmp_path, monkeypatch):
    """The real-dataset flow: KITTI directory tree -> CLI -> TUM + GT."""
    from test_torch_datasets import make_kitti_tree

    make_kitti_tree(tmp_path, n_frames=3, n_pts=3000)
    monkeypatch.setenv("KITTI_BASE_DIR", str(tmp_path))
    out_tum = str(tmp_path / "kitti.tum")
    rc = main(["-c", PIPELINE, "--input-kitti-seq", "00", "--raw-capacity", "8192", "--map-slots", "16384",
               "--output-tum-path", out_tum, "-v", "ERROR"] + CPU)
    assert rc == 0
    assert np.loadtxt(out_tum).shape == (3, 8)
    assert np.loadtxt(out_tum + ".gt.tum").shape == (3, 8)


def test_both_clis_agree_over_the_simulator(tmp_path, monkeypatch):
    """The slice as a whole: both packages' CLIs over ``--input-sim 4``."""
    from mola_lidar_odometry_tpu.apps.cli import main as jmain
    from mola_lidar_odometry_tpu.utils import serialization as JS

    for k in ("MOLA_TPU_PALLAS", "MOLA_TPU_PER_VOXEL_NN", "MOLA_TPU_PALLAS_CAPTURE"):
        monkeypatch.setenv(k, "1")
    outs = {}
    for tag, run, extra in (("jax", jmain, []), ("port", main, CPU)):
        paths = [str(tmp_path / f"{tag}.{n}") for n in ("tum", "simplemap.npz", "mm.npz")]
        assert run(["-c", PIPELINE, "--input-sim", "4", "--output-tum-path", paths[0], "--output-simplemap", paths[1],
                    "--output-local-map", paths[2]] + SMALL + extra) == 0
        outs[tag] = paths
    (jt, jsm, jmm), (tt, tsm, tmm) = outs["jax"], outs["port"]
    j, t = np.loadtxt(jt), np.loadtxt(tt)
    assert j.shape == t.shape == (4, 8)
    assert np.array_equal(t[:, 0], j[:, 0])  # stamps
    np.testing.assert_allclose(t[:, 1:4], j[:, 1:4], atol=1e-5, rtol=0)
    qt, qj = t[:, 4:], j[:, 4:] * np.sign(np.sum(t[:, 4:] * j[:, 4:], axis=1, keepdims=True))
    np.testing.assert_allclose(qt, qj, atol=1e-5, rtol=0)  # quaternion entries: half-angles, radians to first order
    assert np.array_equal(np.loadtxt(tt + ".gt.tum"), np.loadtxt(jt + ".gt.tum"))
    ksm, kjsm = S.load_simplemap(tsm), JS.load_simplemap(jsm)
    assert len(ksm) == len(kjsm) > 0
    assert [kf.stamp for kf in ksm] == [kf.stamp for kf in kjsm]
    tmaps, jmaps = S.load_metric_map(tmm, device="cpu"), JS.load_metric_map(jmm)
    assert sorted(tmaps) == sorted(jmaps)
    for name in tmaps:
        assert int(tmaps[name].num_points()[0]) == int(jmaps[name].num_points()) > 0


TPU_ALGO = {"MOLA_TPU_PALLAS": "1", "MOLA_TPU_PER_VOXEL_NN": "1", "MOLA_TPU_PALLAS_CAPTURE": "1"}


def kitti_reference(n_scans: int = 8) -> dict:
    """Both packages on the CPU over ``chip_smoke.py`` phase 10's input: the
    bench's first ``n_scans`` scans (64 x 2048 rays) written as a KITTI
    sequence and read through each package's KITTI reader, lidar3d-default
    at full width, the JAX package running its TPU algorithm (its kernels
    in interpret mode).  Two sizings: the JAX CLI's default capacities
    (131072 raw points, 262144 map slots; the port's CLI pinned to them)
    and the capacities derived from the first scan (the JAX package's
    ``LidarOdometry`` auto-sizing itself; the port's CLI with nothing
    pinned).  Per run the iterations and quality per scan, the mean quality
    after scan 0 and the final-pose GT error against ``poses/00.txt`` (the
    JAX runs' figures are ``chip_smoke.JAX_FIGURES["cli pinned"]`` and
    ``["cli derived"]``); per sizing the largest pose difference between the
    packages' TUM files (m, rad)."""
    import sys
    import tempfile
    import time

    os.environ.update(TPU_ALGO)
    for k in ("MOLA_TPU_RAW_CAPACITY", "MOLA_TPU_MAP_SLOTS", "MP2P_ICP_GENERATE_DEBUG_FILES"):
        os.environ.pop(k, None)
    from mola_lidar_odometry_tpu.apps import cli as jcli
    from mola_lidar_odometry_tpu.apps import datasets as JD
    from mola_lidar_odometry_tpu.models.odometry import LidarOdometry as JLO
    from mola_lidar_odometry_tpu_torch.apps import cli as tcli
    from mola_lidar_odometry_tpu_torch.models.odometry import LidarOdometry as TLO

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    import chip_smoke as cs

    scans, traj = cs.bench_scans(n_scans)
    kitti = ["-c", PIPELINE, "--input-kitti-seq", "00", "--kitti-correction-angle-deg", "0", "-v", "ERROR"]
    pinned = ["--raw-capacity", str(1 << 17), "--map-slots", str(1 << 18)]
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        cs.write_kitti(tmp, scans, traj)
        os.environ["KITTI_BASE_DIR"] = tmp
        gt = os.path.join(tmp, "gt.tum")

        def jax_cli(path):
            jcli.main(kitti + ["--output-tum-path", path])
            os.replace(path + ".gt.tum", gt)

        def jax_auto(path):
            lo = JLO.from_yaml_file(PIPELINE)
            ds = JD.KittiOdometryDataset("00", vertical_angle_correction_deg=0.0)
            for i in range(len(ds)):
                fr = ds.get(i)
                lo.on_lidar_scan(fr.xyz, fr.stamp, times=fr.times, intensity=fr.intensity, ring=fr.ring)
            lo.save_trajectory_tum(path)

        def port_cli(extra):
            return lambda path: tcli.run(kitti + extra + ["--output-tum-path", path, "--device", "cpu"])

        runs = (("jax", "pinned", jax_cli, JLO), ("jax", "derived", jax_auto, JLO),
                ("port", "pinned", port_cli(pinned), TLO), ("port", "derived", port_cli([]), TLO))
        for pkg, sizing, fn, cls in runs:
            t0, outs, step = time.time(), [], cls.on_lidar_scan
            cls.on_lidar_scan = lambda self, *a, **k: outs.append(step(self, *a, **k)) or outs[-1]
            try:
                path = os.path.join(tmp, f"{pkg}.{sizing}.tum")
                fn(path)
            finally:
                cls.on_lidar_scan = step
            q = [float(o.quality) for o in outs]
            res[f"{pkg} {sizing}"] = r = dict(
                iterations=[int(o.iterations) for o in outs], final_pose_gt_error=cs.gt_error_tum(path, gt),
                quality=q, mean_quality=float(np.mean(q[1:])), seconds=round(time.time() - t0, 1))
            print(f"{pkg} {sizing}: {r}", flush=True)
        for sizing in ("pinned", "derived"):
            res[f"pose gap {sizing} (m, rad)"] = cs.tum_gap(*(os.path.join(tmp, f"{p}.{sizing}.tum")
                                                            for p in ("jax", "port")))
    return res


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_cli.py [n_scans]
    import json
    import sys

    print(json.dumps(kitti_reference(int(sys.argv[1]) if len(sys.argv) > 1 else 8)), flush=True)
