"""Port parity for the MRPT CArchive interop (``utils/mrpt_io.py`` and the
``.simplemap``/``.mm`` bridge of ``utils/serialization.py``): the cases of
``tests/test_mrpt_io.py`` on the port's copy, and in each a file written by
one package is read by the other and the decompressed bytes of both
packages' files are equal (gzip stamps its mtime into the header, so the
compressed files may differ)."""

import gzip
import io
import os

import numpy as np
import pytest
import torch

from mola_lidar_odometry_tpu.utils import mrpt_io as JM
from mola_lidar_odometry_tpu_torch.utils import mrpt_io as M

HERE = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port steps on one torch thread (the tests run beside others)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand_pose(mod, rng):
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    if q[0] < 0:
        q = -q
    return mod.MrptPose3D(rng.normal(size=3) * 10.0, q)


def _same_bytes(a, b):
    assert gzip.open(a).read() == gzip.open(b).read()


def test_pose_quat_conversions():
    rng = np.random.default_rng(0)
    for _ in range(20):
        p = _rand_pose(M, rng)
        R = p.R()
        q2 = M.rot_to_quat_wxyz(R)
        np.testing.assert_allclose(M.quat_wxyz_to_rot(q2), R, atol=1e-12)
        assert np.array_equal(q2, JM.rot_to_quat_wxyz(R)) and np.array_equal(R, JM.MrptPose3D(p.t, p.quat_wxyz).R())


def test_timestamp_roundtrip():
    t = 1726590000.1234567
    assert abs(M.mrpt_timestamp_to_unix(M.unix_to_mrpt_timestamp(t)) - t) < 1e-6
    assert M.unix_to_mrpt_timestamp(t) == JM.unix_to_mrpt_timestamp(t)


def test_framing_null_and_endflag():
    bufs = []
    for mod in (M, JM):
        buf = io.BytesIO()
        w = mod.ArchiveWriter(buf)
        w.null_object()
        w.begin_object("CPose3D", 2)
        w.f64_array(np.zeros(7))
        w.end_object()
        bufs.append(buf.getvalue())
    assert bufs[0] == bufs[1]
    r = M.ArchiveReader(io.BytesIO(bufs[0]))
    assert r.begin_object() == (None, 0)
    assert r.begin_object() == ("CPose3D", 2)


def _entries(mod):
    rng = np.random.default_rng(1)
    entries = []
    for i in range(4):
        obs = []
        if i != 2:  # one pose-only (non-KF) entry
            obs.append(
                mod.MrptObservation(
                    classname="CObservationPointCloud", sensor_label="lidar", stamp=100.0 + i * 0.1,
                    sensor_pose=_rand_pose(mod, rng), points=rng.normal(size=(50, 3)).astype(np.float32),
                    intensity=rng.uniform(size=50).astype(np.float32),
                )
            )
        entries.append(mod.MrptSimpleMapEntry(pose=_rand_pose(mod, rng), cov=rng.normal(size=(6, 6)),
                                              observations=obs, twist=rng.normal(size=6)))
    return entries


def test_simplemap_roundtrip_and_bytes_equal_jax(tmp_path):
    entries = _entries(M)
    p, pj = tmp_path / "t.simplemap", tmp_path / "j.simplemap"
    M.save_simplemap_mrpt(p, entries)
    JM.save_simplemap_mrpt(pj, _entries(JM))
    _same_bytes(p, pj)
    for back in (M.load_simplemap_mrpt(p), JM.load_simplemap_mrpt(p), M.load_simplemap_mrpt(pj)):
        assert len(back) == 4
        for a, b in zip(entries, back):
            np.testing.assert_allclose(a.pose.t, b.pose.t, atol=1e-12)
            np.testing.assert_allclose(a.pose.quat_wxyz, b.pose.quat_wxyz, atol=1e-12)
            np.testing.assert_allclose(a.cov, b.cov, atol=1e-12)
            np.testing.assert_allclose(a.twist, b.twist, atol=1e-12)
            assert len(a.observations) == len(b.observations)
            for oa, ob in zip(a.observations, b.observations):
                np.testing.assert_array_equal(oa.points, ob.points)
                np.testing.assert_array_equal(oa.intensity, ob.intensity)
                assert abs(oa.stamp - ob.stamp) < 1e-6
                assert oa.sensor_label == ob.sensor_label


def test_simplemap_is_gzip(tmp_path):
    p = tmp_path / "t.simplemap"
    M.save_simplemap_mrpt(p, [])
    assert open(p, "rb").read(2) == b"\x1f\x8b"


def _keyframes(cls):
    rng = np.random.default_rng(2)
    kfs = []
    for i in range(3):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        kfs.append(cls(stamp=10.0 + i, t=rng.normal(size=3), quat_xyzw=q, twist=rng.normal(size=6),
                       scan_xyz=rng.normal(size=(30, 3)).astype(np.float32)))
    return kfs


def test_keyframe_bridge_roundtrip_both_ways(tmp_path):
    """export_simplemap_mrpt -> import_simplemap_mrpt: identical keyframe
    poses and points, in each package and across them."""
    from mola_lidar_odometry_tpu.models.odometry import SimpleMapKeyframe as JKF
    from mola_lidar_odometry_tpu.utils import serialization as JS
    from mola_lidar_odometry_tpu_torch.models.odometry import SimpleMapKeyframe
    from mola_lidar_odometry_tpu_torch.utils import serialization as S

    kfs = _keyframes(SimpleMapKeyframe)
    p, pj = tmp_path / "kf.simplemap", tmp_path / "jkf.simplemap"
    S.export_simplemap_mrpt(p, kfs)
    JS.export_simplemap_mrpt(pj, _keyframes(JKF))
    _same_bytes(p, pj)
    for back in (S.import_simplemap_mrpt(p), JS.import_simplemap_mrpt(p), S.import_simplemap_mrpt(pj)):
        assert len(back) == 3
        for a, b in zip(kfs, back):
            np.testing.assert_allclose(a.t, b.t, atol=1e-12)
            qa, qb = a.quat_xyzw, b.quat_xyzw
            if np.dot(qa, qb) < 0:
                qb = -qb
            np.testing.assert_allclose(qa, qb, atol=1e-12)
            np.testing.assert_allclose(a.twist, b.twist, atol=1e-12)
            np.testing.assert_array_equal(a.scan_xyz, b.scan_xyz)


def test_metric_map_roundtrip_and_bytes_equal_jax(tmp_path):
    rng = np.random.default_rng(3)
    layers = {
        "localmap": (rng.normal(size=(200, 3)).astype(np.float32), None),
        "edges": (rng.normal(size=(40, 3)).astype(np.float32), rng.uniform(size=40).astype(np.float32)),
    }
    p, pj = tmp_path / "t.mm", tmp_path / "j.mm"
    M.save_metric_map_mrpt(p, layers)
    JM.save_metric_map_mrpt(pj, layers)
    _same_bytes(p, pj)
    for back in (M.load_metric_map_mrpt(p), JM.load_metric_map_mrpt(p)):
        assert set(back) == {"localmap", "edges"}
        np.testing.assert_array_equal(back["localmap"][0], layers["localmap"][0])
        np.testing.assert_array_equal(back["edges"][1], layers["edges"][1])


def test_export_from_live_map_equals_jax(tmp_path):
    """The same points inserted into both packages' maps export to the same
    ``.mm`` bytes (the port's map word for word, unwrapped near the anchor
    its live keys give, as the JAX package's)."""
    import jax.numpy as jnp

    from mola_lidar_odometry_tpu.ops import voxel_hash as jvh
    from mola_lidar_odometry_tpu.ops.pointcloud import PointCloud as JPC
    from mola_lidar_odometry_tpu.utils import serialization as JS
    from mola_lidar_odometry_tpu_torch.ops import voxel_hash as vh
    from mola_lidar_odometry_tpu_torch.ops.pointcloud import PointCloud
    from mola_lidar_odometry_tpu_torch.utils import serialization as S

    pts = np.random.default_rng(4).normal(size=(100, 3)).astype(np.float32) * 5
    jm = jvh.insert(jvh.VoxelHashMap.create(1 << 10, 8, 0.5), JPC.from_xyz(jnp.asarray(pts)))
    m = vh.VoxelHashMap.create(1 << 10, 8, 0.5, 1, "cpu")
    m = vh.insert_stats(m, PointCloud.from_xyz(torch.from_numpy(pts)[None]))[0]
    assert np.array_equal(m.data[0].numpy(), np.asarray(jm.data))
    p, pj = tmp_path / "live.mm", tmp_path / "jlive.mm"
    S.export_metric_map_mrpt(p, {"localmap": m}, capacity=512)
    JS.export_metric_map_mrpt(pj, {"localmap": jm}, capacity=512)
    _same_bytes(p, pj)
    back = S.import_metric_map_mrpt(p)
    assert len(back["localmap"]) == int(m.num_points()[0]) == int(jm.num_points())


def _make_rawlog(mod, path, n=3):
    """A rawlog of simulator scans."""
    from mola_lidar_odometry_tpu_torch.utils import sim

    traj, scans = sim.simulate_sequence(n, n_rings=16, n_azimuth=256)
    frames = []
    for k, (xyz, times, rings, valid) in enumerate(scans):
        frames.append([mod.MrptObservation(
            classname="CObservationPointCloud", sensor_label="lidar", stamp=float(traj.stamps[k]),
            sensor_pose=mod.MrptPose3D(np.zeros(3), np.array([1.0, 0, 0, 0])), points=xyz[valid].astype(np.float32),
        )])
    mod.write_rawlog(path, frames)
    return frames


def test_rawlog_roundtrip_and_bytes_equal_jax(tmp_path):
    p, pj = tmp_path / "seq.rawlog", tmp_path / "jseq.rawlog"
    frames = _make_rawlog(M, p)
    _make_rawlog(JM, pj)
    _same_bytes(p, pj)
    for back in (M.read_rawlog(p), JM.read_rawlog(p)):
        assert len(back) == len(frames)
        for a, b in zip(frames, back):
            np.testing.assert_array_equal(a[0].points, b[0].points)


def test_2d_scan_entry(tmp_path):
    obs = M.MrptObservation(
        classname="CObservation2DRangeScan", sensor_label="scan2d", stamp=5.0,
        sensor_pose=M.MrptPose3D(np.zeros(3), np.array([1.0, 0, 0, 0])), aperture=np.pi, right_to_left=True,
        max_range=30.0, scan_ranges=np.linspace(1, 5, 64).astype(np.float32), scan_validity=np.ones(64, np.uint8),
    )
    p = tmp_path / "scan2d.rawlog"
    M.write_rawlog(p, [[obs]])
    for back in (M.read_rawlog(p), JM.read_rawlog(p)):
        np.testing.assert_array_equal(back[0][0].scan_ranges, obs.scan_ranges)
        assert back[0][0].aperture == pytest.approx(np.pi)


def test_rawlog_dataset_e2e(tmp_path):
    """RawlogDataset gives the JAX reader's frames bit for bit and drives
    the port's odometry (the reference's fixture shape: rawlog -> poses,
    test/test_lidar_odometry_rawlog.cpp)."""
    from mola_lidar_odometry_tpu.apps.datasets import RawlogDataset as JRawlog
    from mola_lidar_odometry_tpu_torch.apps.datasets import RawlogDataset
    from mola_lidar_odometry_tpu_torch.models.odometry import LidarOdometry

    p = tmp_path / "seq.rawlog"
    _make_rawlog(M, p)
    ds, jds = RawlogDataset(str(p)), JRawlog(str(p))
    assert len(ds) == len(jds) == 3
    lo = LidarOdometry.from_yaml_file(
        os.path.join(HERE, "..", "pipelines", "lidar3d-default.yaml"), device="cpu",
        raw_capacity=1 << 13, map_slots=1 << 14,
        layer_capacities={"raw": 1 << 13, "decimated_for_map_raw": 4096, "decimated_for_icp_skewed": 2048,
                          "decimated_for_icp": 2048, "decimated_for_map": 4096},
    )
    for i in range(len(ds)):
        fr, jfr = ds.get(i), jds.get(i)
        assert fr.stamp == jfr.stamp and fr.label == jfr.label
        np.testing.assert_array_equal(fr.xyz, jfr.xyz)
        out = lo.on_lidar_scan(fr.xyz, fr.stamp)
        assert np.all(np.isfinite(out.pose_t))
    assert len(lo.trajectory) == 3
