"""Port parity for the dataset readers (``apps/datasets.py``): the cases of
``tests/test_datasets.py`` on the port's readers over synthetic on-disk
trees, and every frame equal bit for bit to the JAX package's reader on the
same files.  The KITTI reader runs with the numpy decode and with the
native library (built from ``native/`` into a temporary directory), the
same decoder for both packages in each case."""

import os
import shutil
import subprocess

import numpy as np
import pytest

from mola_lidar_odometry_tpu.apps import datasets as JD
from mola_lidar_odometry_tpu_torch.apps import datasets as D

NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "native")


def make_kitti_tree(root, seq="00", n_frames=3, n_pts=50):
    rng = np.random.default_rng(0)
    seqd = root / "sequences" / seq
    (seqd / "velodyne").mkdir(parents=True)
    clouds = []
    for k in range(n_frames):
        pts = rng.uniform(-10, 10, (n_pts, 4)).astype(np.float32)
        pts.tofile(seqd / "velodyne" / f"{k:06d}.bin")
        clouds.append(pts)
    (seqd / "times.txt").write_text("".join(f"{0.1 * k:.6f}\n" for k in range(n_frames)))
    tr = " ".join(str(v) for v in [1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0])
    (seqd / "calib.txt").write_text(f"Tr: {tr}\n")  # identity Tr: cam0 == velodyne
    poses = root / "poses"
    poses.mkdir()
    lines = []
    for k in range(n_frames):
        T = np.eye(4)
        T[0, 3] = k * 1.0
        lines.append(" ".join(f"{v:.6f}" for v in T[:3].reshape(-1)))
    (poses / f"{seq}.txt").write_text("\n".join(lines) + "\n")
    return clouds


def same_frames(ds, jds):
    """Every frame of the port's reader equals the JAX reader's."""
    assert len(ds) == len(jds)
    for i in range(len(ds)):
        a, b = ds.get(i), jds.get(i)
        assert a.stamp == b.stamp and a.label == b.label
        for f in ("xyz", "times", "intensity", "ring"):
            x, y = getattr(a, f), getattr(b, f)
            assert (x is None) == (y is None), f
            if x is not None:
                assert x.dtype == y.dtype and np.array_equal(x, y), f"{f} of frame {i}"
    ga, gb = ds.ground_truth(), jds.ground_truth()
    assert (ga is None) == (gb is None)
    if ga is not None:
        for f in ("stamps", "t", "quat_xyzw"):
            np.testing.assert_array_equal(getattr(ga, f), getattr(gb, f))


@pytest.fixture(params=["numpy", "native"])
def decoder(request, tmp_path_factory):
    """Both packages' KITTI decode on one path: numpy (no library) or the
    native library built from the repo's sources."""
    from mola_lidar_odometry_tpu.utils import native as jnative
    from mola_lidar_odometry_tpu_torch.utils import native

    mp = pytest.MonkeyPatch()
    mods = (native, jnative)
    saved = [(m._LIB, m._TRIED) for m in mods]
    if request.param == "native":
        d = tmp_path_factory.mktemp("native")
        shutil.copytree(NATIVE_DIR, d, ignore=shutil.ignore_patterns("*.so"), dirs_exist_ok=True)
        subprocess.run(["make", "-C", str(d)], check=True, capture_output=True)
        mp.setenv("MOLA_TPU_NATIVE_LIB", str(d / "libmola_tpu_native.so"))
        for m in mods:
            m._LIB, m._TRIED = None, False
        assert native.available() and jnative.available()
    else:
        for m in mods:
            m._LIB, m._TRIED = None, True
    yield request.param
    for m, (lib, tried) in zip(mods, saved):
        m._LIB, m._TRIED = lib, tried
    mp.undo()


def test_kitti_reader_roundtrip(tmp_path, decoder):
    from mola_lidar_odometry_tpu_torch.utils import native

    clouds = make_kitti_tree(tmp_path)
    kw = dict(base_dir=str(tmp_path), vertical_angle_correction_deg=0.0)
    ds = D.KittiOdometryDataset("00", **kw)
    calls = native.decode_bin.calls
    fr = ds.get(1)
    assert native.decode_bin.calls == calls + (decoder == "native")
    np.testing.assert_allclose(fr.xyz, clouds[1][:, :3], rtol=1e-6)
    np.testing.assert_allclose(fr.intensity, clouds[1][:, 3], rtol=1e-6)
    assert fr.stamp == pytest.approx(0.1)
    assert fr.times is not None and fr.times.shape == (50,)
    same_frames(ds, JD.KittiOdometryDataset("00", **kw))
    kw["vertical_angle_correction_deg"] = 0.205
    same_frames(D.KittiOdometryDataset("00", **kw), JD.KittiOdometryDataset("00", **kw))


def test_kitti_vertical_correction_preserves_range(tmp_path):
    make_kitti_tree(tmp_path)
    ds0 = D.KittiOdometryDataset("00", base_dir=str(tmp_path), vertical_angle_correction_deg=0.0)
    ds1 = D.KittiOdometryDataset("00", base_dir=str(tmp_path), vertical_angle_correction_deg=0.205)
    r0 = np.linalg.norm(ds0.get(0).xyz, axis=1)
    r1 = np.linalg.norm(ds1.get(0).xyz, axis=1)
    np.testing.assert_allclose(r0, r1, rtol=1e-4)
    assert not np.allclose(ds0.get(0).xyz[:, 2], ds1.get(0).xyz[:, 2])


def test_kitti_ground_truth_in_velodyne_frame(tmp_path):
    make_kitti_tree(tmp_path)
    gt = D.KittiOdometryDataset("00", base_dir=str(tmp_path)).ground_truth()
    assert gt is not None and gt.t.shape == (3, 3)
    np.testing.assert_allclose(gt.t[:, 0], [0.0, 1.0, 2.0], atol=1e-6)
    jgt = JD.KittiOdometryDataset("00", base_dir=str(tmp_path)).ground_truth()
    np.testing.assert_array_equal(gt.t, jgt.t)
    np.testing.assert_array_equal(gt.quat_xyzw, jgt.quat_xyzw)


def test_kitti_missing_base_dir():
    with pytest.raises(FileNotFoundError, match="KITTI_BASE_DIR"):
        D.KittiOdometryDataset("00", base_dir="/nonexistent/kitti")


def test_mulran_reader(tmp_path):
    rng = np.random.default_rng(1)
    d = tmp_path / "KAIST01" / "Ouster"
    d.mkdir(parents=True)
    t0 = 1_500_000_000_000_000_000
    for k in range(2):
        rng.uniform(-5, 5, (20, 4)).astype(np.float32).tofile(d / f"{t0 + k * 100_000_000}.bin")
    ds = D.MulranDataset("KAIST01", base_dir=str(tmp_path))
    assert len(ds) == 2
    assert ds.get(1).stamp == pytest.approx(0.1)
    same_frames(ds, JD.MulranDataset("KAIST01", base_dir=str(tmp_path)))


def test_kitti360_reader_and_gt(tmp_path):
    rng = np.random.default_rng(2)
    drive = "2013_05_28_drive_0000_sync"
    d = tmp_path / "data_3d_raw" / drive / "velodyne_points" / "data"
    d.mkdir(parents=True)
    for k in range(2):
        rng.uniform(-5, 5, (20, 4)).astype(np.float32).tofile(d / f"{k:010d}.bin")
    gtd = tmp_path / "data_poses" / drive
    gtd.mkdir(parents=True)
    T = np.eye(4)
    T[1, 3] = 2.5
    (gtd / "poses.txt").write_text("1 " + " ".join(f"{v:.6f}" for v in T[:3].reshape(-1)) + "\n")
    ds = D.Kitti360Dataset("00", base_dir=str(tmp_path))
    assert len(ds) == 2
    gt = ds.ground_truth()
    assert gt is not None
    np.testing.assert_allclose(gt.t[0], [0.0, 2.5, 0.0], atol=1e-6)
    same_frames(ds, JD.Kitti360Dataset("00", base_dir=str(tmp_path)))


def test_paris_luco_binary_ply(tmp_path):
    d = tmp_path / "frames"
    d.mkdir()
    n = 10
    rng = np.random.default_rng(3)
    data = np.zeros(n, dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4"), ("timestamp", "<f4")])
    for f in ("x", "y", "z", "timestamp"):
        data[f] = rng.uniform(0, 1, n).astype(np.float32)
    header = ("ply\nformat binary_little_endian 1.0\n" f"element vertex {n}\n"
              "property float x\nproperty float y\nproperty float z\nproperty float timestamp\nend_header\n")
    with open(d / "frame_0000.ply", "wb") as f:
        f.write(header.encode())
        f.write(data.tobytes())
    ds = D.ParisLucoDataset(base_dir=str(tmp_path))
    fr = ds.get(0)
    np.testing.assert_allclose(fr.xyz[:, 0], data["x"], rtol=1e-6)
    assert abs(fr.times.min() + fr.times.max()) < 1e-5  # timestamps centered (MiddleIsZero-style)
    same_frames(ds, JD.ParisLucoDataset(base_dir=str(tmp_path)))


def test_sim_dataset_gt():
    ds = D.SimDataset(3, n_rings=8, n_azimuth=64)
    assert len(ds) == 3
    gt = ds.ground_truth()
    assert gt.t.shape == (3, 3) and gt.quat_xyzw.shape == (3, 4)
    same_frames(ds, JD.SimDataset(3, n_rings=8, n_azimuth=64))


def test_bag_frames_equal_jax(tmp_path):
    """The rosbag2 reader over a ``.db3`` and an ``.mcap`` of the same
    simulated scans (per-point stamps, rings, intensities)."""
    from mola_lidar_odometry_tpu_torch.utils import mcap, rosbag2, sim

    traj, scans = sim.simulate_sequence(2, n_rings=8, n_azimuth=128)
    rng = np.random.default_rng(4)
    frames = [(float(traj.stamps[k]) + 1.0, xyz[valid],
               dict(times=times[valid], ring=rings[valid].astype(np.uint16),
                    intensity=rng.uniform(0, 1, int(valid.sum())).astype(np.float32)))
              for k, (xyz, times, rings, valid) in enumerate(scans)]
    for name, write in (("b.db3", rosbag2.write_pointcloud2_db3), ("b.mcap", mcap.write_pointcloud2_mcap)):
        write(str(tmp_path / name), frames)
        ds = D.Rosbag2Dataset(str(tmp_path / name))
        assert ds.get(1).times is not None and ds.get(1).intensity is not None
        same_frames(ds, JD.Rosbag2Dataset(str(tmp_path / name)))
