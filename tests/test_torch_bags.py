"""Port parity for the bag readers and writers (``utils/rosbag2.py``,
``utils/mcap.py``): the cases of ``tests/test_rosbag2.py`` and
``tests/test_mcap.py`` on the port's copies.  Each encoder's bytes equal the
JAX package's, each package reads the other's bag, and the odometry cases
step the port (``device="cpu"``) from the bag."""

import os
import struct

import numpy as np
import pytest
import torch

from mola_lidar_odometry_tpu.utils import mcap as jmcap, rosbag2 as jrosbag2
from mola_lidar_odometry_tpu_torch.apps.datasets import Rosbag2Dataset
from mola_lidar_odometry_tpu_torch.models.odometry import LidarOdometry
from mola_lidar_odometry_tpu_torch.utils import mcap, sim
from mola_lidar_odometry_tpu_torch.utils.rosbag2 import (
    Db3Reader,
    encode_pointcloud2,
    parse_pointcloud2,
    write_pointcloud2_db3,
)

PIPELINE = os.path.join(os.path.dirname(__file__), "..", "pipelines", "lidar3d-default.yaml")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port steps on one torch thread (the tests run beside others)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny_caps(raw, layer):
    names = ("decimated_for_map_raw", "decimated_for_icp_skewed", "decimated_for_icp", "decimated_for_map")
    return dict(raw_capacity=raw, map_slots=2 * raw, layer_capacities={"raw": raw, **{n: layer for n in names}})


def test_cdr_roundtrip_and_bytes_equal_jax():
    rng = np.random.default_rng(0)
    xyz = rng.uniform(-10, 10, (257, 3)).astype(np.float32)
    inten = rng.uniform(0, 100, 257).astype(np.float32)
    times = rng.uniform(0, 0.1, 257).astype(np.float32)
    ring = rng.integers(0, 64, 257).astype(np.uint16)
    kw = dict(intensity=inten, times=times, ring=ring, frame_id="velodyne")
    blob = encode_pointcloud2(123.456789, xyz, **kw)
    assert blob == jrosbag2.encode_pointcloud2(123.456789, xyz, **kw)
    for msg in (parse_pointcloud2(blob), jrosbag2.parse_pointcloud2(blob)):
        assert msg.frame_id == "velodyne"
        assert abs(msg.stamp - 123.456789) < 1e-6
        ch = msg.records()
        np.testing.assert_array_equal(ch["x"], xyz[:, 0])
        np.testing.assert_array_equal(ch["z"], xyz[:, 2])
        np.testing.assert_array_equal(ch["intensity"], inten)
        np.testing.assert_array_equal(ch["t"], times)
        np.testing.assert_array_equal(ch["ring"], ring)


def _frames(n=3):
    rng = np.random.default_rng(1)
    return [(10.0 + 0.1 * k, rng.uniform(-5, 5, (100 + k, 3)).astype(np.float32), dict(ring=np.arange(100 + k) % 8))
            for k in range(n)]


def test_db3_write_read_both_packages(tmp_path):
    bag, jbag = tmp_path / "run.db3", tmp_path / "jrun.db3"
    frames = _frames()
    write_pointcloud2_db3(str(bag), frames)
    jrosbag2.write_pointcloud2_db3(str(jbag), frames)
    for path in (bag, jbag):
        r, jr = Db3Reader(str(path)), jrosbag2.Db3Reader(str(path))
        assert len(r) == len(jr) == 3 and r.topic == "/points"
        for i in range(3):
            (s, m), (js, jm) = r.message(i), jr.message(i)
            assert s == js and m.data == jm.data and m.width == 100 + i
        ds = Rosbag2Dataset(str(path))
        assert len(ds) == 3
        fr = ds.get(2)
        assert fr.xyz.shape == (102, 3)
        assert fr.ring is not None and int(fr.ring.max()) == 7
        assert abs(fr.stamp - 10.2) < 1e-6
        with pytest.raises(ValueError):
            Rosbag2Dataset(str(path), topic="/other")


def test_odometry_runs_from_db3(tmp_path):
    """Simulator -> bag -> dataset -> the port's odometry: the reference's
    rosbag2 e2e shape (test_lidar_odometry_rosbag2.cpp) without ROS."""
    traj, scans = sim.simulate_sequence(3, n_rings=8, n_azimuth=128)
    bag = tmp_path / "sim.db3"
    frames = [(float(traj.stamps[k]) + 1.0, xyz[valid], dict(times=times[valid], ring=rings[valid].astype(np.uint16)))
              for k, (xyz, times, rings, valid) in enumerate(scans)]
    write_pointcloud2_db3(str(bag), frames)
    ds = Rosbag2Dataset(str(bag))
    lo = LidarOdometry.from_yaml_file(PIPELINE, env={}, device="cpu", **_tiny_caps(1 << 12, 1024))
    for i in range(len(ds)):
        fr = ds.get(i)
        out = lo.on_lidar_scan(fr.xyz, fr.stamp, times=fr.times, ring=fr.ring, intensity=fr.intensity)
    assert bool(out.processed)
    assert np.all(np.isfinite(out.pose_t))


def test_mcap_write_read_and_bytes_equal_jax(tmp_path):
    bag, jbag = tmp_path / "run.mcap", tmp_path / "jrun.mcap"
    frames = _frames()
    mcap.write_pointcloud2_mcap(str(bag), frames)
    jmcap.write_pointcloud2_mcap(str(jbag), frames)
    assert bag.read_bytes() == jbag.read_bytes()
    assert mcap.list_topics(str(bag)) == {"/points": "sensor_msgs/msg/PointCloud2"}
    r = mcap.McapReader(str(bag))
    assert len(r) == 3 and r.topic == "/points"
    stamp, msg = r.message(1)
    assert abs(stamp - 10.1) < 1e-6
    assert msg.width == 101
    np.testing.assert_array_equal(msg.records()["x"], frames[1][1][:, 0])
    ds = Rosbag2Dataset(str(bag))
    assert len(ds) == 3
    fr = ds.get(2)
    assert fr.xyz.shape == (102, 3)
    assert fr.ring is not None and int(fr.ring.max()) == 7
    with pytest.raises(ValueError):
        Rosbag2Dataset(str(bag), topic="/other")


def test_mcap_zstd_chunked(tmp_path):
    """Real rosbag2 mcap writers chunk + zstd-compress; the bag rebuilt with
    its Schema/Channel/Message records in one zstd Chunk reads the same in
    both packages."""
    zstandard = pytest.importorskip("zstandard")
    plain = tmp_path / "plain.mcap"
    frames = _frames()
    mcap.write_pointcloud2_mcap(str(plain), frames)
    buf = plain.read_bytes()
    inner, off = [], 8
    while off < len(buf) - 8:
        op = buf[off]
        (length,) = struct.unpack_from("<Q", buf, off + 1)
        rec = buf[off : off + 9 + length]
        off += 9 + length
        if op in (mcap.OP_SCHEMA, mcap.OP_CHANNEL, mcap.OP_MESSAGE):
            inner.append(rec)
    records = b"".join(inner)
    comp = zstandard.ZstdCompressor().compress(records)
    chunk_body = (struct.pack("<QQQI", 0, 0, len(records), 0) + struct.pack("<I", 4) + b"zstd"
                  + struct.pack("<Q", len(comp)) + comp)
    chunked = (
        mcap.MAGIC + buf[8 : 8 + 9 + struct.unpack_from("<Q", buf, 9)[0]]
        + struct.pack("<BQ", mcap.OP_CHUNK, len(chunk_body)) + chunk_body
        + struct.pack("<BQI", mcap.OP_DATA_END, 4, 0) + struct.pack("<BQQQI", mcap.OP_FOOTER, 20, 0, 0, 0) + mcap.MAGIC
    )
    bag = tmp_path / "chunked.mcap"
    bag.write_bytes(chunked)
    for reader in (mcap.McapReader, jmcap.McapReader):
        r = reader(str(bag))
        assert len(r) == 3
        np.testing.assert_array_equal(r.message(2)[1].records()["y"], frames[2][1][:, 1])


def test_odometry_deskew_pose_gate_from_mcap(tmp_path):
    """Simulator (moving sensor, per-point stamps) -> mcap -> dataset -> the
    port's odometry with the deskew path live -> per-pose gate vs GT (0.2,
    as the JAX package's case)."""
    from mola_lidar_odometry_tpu_torch.ops import se3

    traj, scans = sim.simulate_sequence(n_frames=8, dt=0.1, speed=2.0, noise=0.01)
    bag = tmp_path / "sim.mcap"
    frames = [(float(traj.stamps[k]) + 1.0, xyz[valid], dict(times=times[valid], ring=rings[valid].astype(np.uint16)))
              for k, (xyz, times, rings, valid) in enumerate(scans)]
    mcap.write_pointcloud2_mcap(str(bag), frames)
    ds = Rosbag2Dataset(str(bag))
    caps = dict(_tiny_caps(1 << 15, 8192), map_slots=1 << 15)
    lo = LidarOdometry.from_yaml_file(PIPELINE, env={}, device="cpu", **caps)
    for i in range(len(ds)):
        fr = ds.get(i)
        assert fr.times is not None  # the deskew path must actually engage
        lo.on_lidar_scan(fr.xyz, fr.stamp, times=fr.times, ring=fr.ring, intensity=fr.intensity)
    tr = lo.estimated_trajectory()
    assert len(tr["stamps"]) == len(ds)
    R0, t0 = traj.R[0], traj.t[0]
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))  # noqa: E731
    worst = 0.0
    for k in range(len(ds)):
        gt = se3.Pose(f32(R0.T @ traj.R[k]), f32(R0.T @ (traj.t[k] - t0)))
        est = se3.Pose(se3.quat_to_rot(f32(tr["quat_xyzw"][k])), f32(tr["t"][k]))
        worst = max(worst, float(torch.linalg.norm(se3.se3_log(se3.relative(gt, est)))))
    assert worst < 0.2, f"worst SE(3) log-norm error {worst}"
