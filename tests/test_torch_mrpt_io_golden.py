"""Port parity for ``utils/mrpt_io.py`` against frozen bytes: the golden
CArchive fixtures of ``tests/test_mrpt_io.py`` (hand-assembled with raw
struct from docs/mrpt_format.md, their sha256 pinned) read and written by
the port's copy, and each container written by one package read by the
other with the decompressed bytes equal."""

import gzip

import numpy as np
import pytest

from mola_lidar_odometry_tpu.utils import mrpt_io as JM
from mola_lidar_odometry_tpu_torch.utils import mrpt_io as M


def _hdr(name: str, version: int) -> bytes:
    """CArchive object header, assembled with raw struct only."""
    import struct

    return bytes([0x80 | len(name)]) + name.encode("ascii") + struct.pack("<b", version)


_END = b"\x88"


def _f32vec(vals) -> bytes:
    import struct

    a = np.asarray(vals, "<f4").ravel()
    return struct.pack("<I", len(a)) + a.tobytes()


def _f64s(vals) -> bytes:
    return np.asarray(vals, "<f8").ravel().tobytes()


def _string(s: str) -> bytes:
    import struct

    b = s.encode("utf-8")
    return struct.pack("<I", len(b)) + b


def _u32(v) -> bytes:
    import struct

    return struct.pack("<I", v)


def _u64(v) -> bytes:
    import struct

    return struct.pack("<Q", v)


def _f64(v) -> bytes:
    import struct

    return struct.pack("<d", v)


# unix stamp 0.0 == FILETIME ticks of the unix epoch
_TS0 = 116444736000000000

_POSE_ID = _hdr("CPose3D", 2) + _f64s([0, 0, 0, 1, 0, 0, 0]) + _END


def _golden_mm() -> bytes:
    """metric_map_t v0, one 'localmap' CSimplePointsMap of 2 points."""
    pts = (
        _hdr("CSimplePointsMap", 0)
        + _f32vec([1.0, 4.0])  # x
        + _f32vec([2.0, 5.0])  # y
        + _f32vec([3.0, 6.0])  # z
        + _END
    )
    return _hdr("metric_map_t", 0) + _u32(1) + _string("localmap") + pts + _END


def _golden_simplemap() -> bytes:
    """CSimpleMap v1, one keyframe: pose PDF + 1-obs sensory frame + twist."""
    pose = _hdr("CPose3D", 2) + _f64s([1.0, 2.0, 3.0, 1.0, 0.0, 0.0, 0.0]) + _END
    cov = _f64s(0.01 * np.eye(6))
    pdf = _hdr("CPose3DPDFGaussian", 1) + pose + cov + _END
    cloud = (
        _hdr("CSimplePointsMap", 0)
        + _f32vec([7.0])
        + _f32vec([8.0])
        + _f32vec([9.0])
        + _END
    )
    obs = (
        _hdr("CObservationPointCloud", 0)
        + _string("lidar")
        + _u64(_TS0)
        + _POSE_ID
        + cloud
        + _END
    )
    sf = _hdr("CSensoryFrame", 2) + _u32(1) + obs + _END
    twist = _f64s([0.5, 0.0, 0.0, 0.0, 0.0, 0.1])
    return _hdr("CSimpleMap", 1) + _u32(1) + pdf + sf + twist + _END


def _golden_rawlog() -> bytes:
    """Observations-only rawlog: one 2D scan, then one point cloud."""
    scan = (
        _hdr("CObservation2DRangeScan", 0)
        + _string("laser")
        + _u64(_TS0)
        + _POSE_ID
        + _f64(np.pi)  # aperture
        + b"\x01"  # rightToLeft
        + _f64(30.0)  # maxRange
        + _f32vec([1.5, 2.5, 3.5])
        + _u32(3)
        + bytes([1, 0, 1])
        + _END
    )
    cloud = (
        _hdr("CObservationPointCloud", 0)
        + _string("lidar")
        + _u64(_TS0 + 10_000_000)  # +1 s
        + _POSE_ID
        + _hdr("CSimplePointsMap", 0)
        + _f32vec([1.0])
        + _f32vec([2.0])
        + _f32vec([3.0])
        + _END
        + _END
    )
    return scan + cloud


class TestGoldenBytes:  # the JAX package's cases, on the port's mrpt_io
    """Frozen byte fixtures hand-assembled from docs/mrpt_format.md.

    The round-trip tests above only prove reader == inverse(writer); these
    pin the ACTUAL bytes, so a layout drift in mrpt_io.py (field order,
    width, endianness, version) fails here instead of producing artifacts
    no MRPT tool can read.  The sha256 pins freeze the hand-assembly too.
    """

    def test_fixture_hashes_pinned(self):
        import hashlib

        assert hashlib.sha256(_golden_mm()).hexdigest() == (
            "fa88e6342df31d2264f7bc509f9ae53d15df9a553621afaa94054bf9911c0dca"
        )
        assert hashlib.sha256(_golden_simplemap()).hexdigest() == (
            "d1d50bc109c2eac415b9f82fb5bc49a65e59e77a74a399cf423a8928ca18e868"
        )
        assert hashlib.sha256(_golden_rawlog()).hexdigest() == (
            "99c0859788b05a5bec07d563a6a7a5186c287357370e90e949e0d9ff0dd80a5c"
        )

    def test_mm_reader_parses_golden(self, tmp_path):
        p = tmp_path / "g.mm"
        p.write_bytes(_golden_mm())  # uncompressed: reader auto-detects
        layers = M.load_metric_map_mrpt(p)
        assert list(layers) == ["localmap"]
        pts, inten = layers["localmap"]
        np.testing.assert_allclose(pts, [[1, 2, 3], [4, 5, 6]])
        assert inten is None

    def test_mm_writer_emits_golden(self, tmp_path):
        import gzip

        p = tmp_path / "w.mm"
        M.save_metric_map_mrpt(
            p, {"localmap": (np.array([[1, 2, 3], [4, 5, 6]], np.float32), None)}
        )
        assert gzip.open(p).read() == _golden_mm()

    def test_simplemap_reader_parses_golden(self, tmp_path):
        p = tmp_path / "g.simplemap"
        p.write_bytes(_golden_simplemap())
        entries = M.load_simplemap_mrpt(p)
        assert len(entries) == 1
        e = entries[0]
        np.testing.assert_allclose(e.pose.t, [1, 2, 3])
        np.testing.assert_allclose(e.cov, 0.01 * np.eye(6))
        assert len(e.observations) == 1
        o = e.observations[0]
        assert o.sensor_label == "lidar" and o.stamp == 0.0
        np.testing.assert_allclose(o.points, [[7, 8, 9]])
        np.testing.assert_allclose(e.twist, [0.5, 0, 0, 0, 0, 0.1])

    def test_simplemap_writer_emits_golden(self, tmp_path):
        import gzip

        p = tmp_path / "w.simplemap"
        entry = M.MrptSimpleMapEntry(
            M.MrptPose3D(np.array([1.0, 2, 3]), np.array([1.0, 0, 0, 0])),
            0.01 * np.eye(6),
            [
                M.MrptObservation(
                    classname="CObservationPointCloud",
                    sensor_label="lidar",
                    stamp=0.0,
                    sensor_pose=M.MrptPose3D(np.zeros(3), np.array([1.0, 0, 0, 0])),
                    points=np.array([[7.0, 8, 9]], np.float32),
                )
            ],
            np.array([0.5, 0, 0, 0, 0, 0.1]),
        )
        M.save_simplemap_mrpt(p, [entry])
        assert gzip.open(p).read() == _golden_simplemap()

    def test_rawlog_reader_parses_golden(self, tmp_path):
        p = tmp_path / "g.rawlog"
        p.write_bytes(_golden_rawlog())
        frames = M.read_rawlog(p)
        assert len(frames) == 2
        s = frames[0][0]
        assert s.classname == "CObservation2DRangeScan"
        assert s.aperture == pytest.approx(np.pi) and s.max_range == 30.0
        assert s.right_to_left is True
        np.testing.assert_allclose(s.scan_ranges, [1.5, 2.5, 3.5])
        np.testing.assert_array_equal(s.scan_validity, [1, 0, 1])
        c = frames[1][0]
        assert c.stamp == pytest.approx(1.0)
        np.testing.assert_allclose(c.points, [[1, 2, 3]])

    def test_rawlog_writer_emits_golden(self, tmp_path):
        import gzip

        p = tmp_path / "w.rawlog"
        pose0 = M.MrptPose3D(np.zeros(3), np.array([1.0, 0, 0, 0]))
        frames = [
            [
                M.MrptObservation(
                    classname="CObservation2DRangeScan",
                    sensor_label="laser",
                    stamp=0.0,
                    sensor_pose=pose0,
                    aperture=float(np.pi),
                    right_to_left=True,
                    max_range=30.0,
                    scan_ranges=np.array([1.5, 2.5, 3.5], np.float32),
                    scan_validity=np.array([1, 0, 1], np.uint8),
                )
            ],
            [
                M.MrptObservation(
                    classname="CObservationPointCloud",
                    sensor_label="lidar",
                    stamp=1.0,
                    sensor_pose=pose0,
                    points=np.array([[1.0, 2, 3]], np.float32),
                )
            ],
        ]
        M.write_rawlog(p, frames)
        assert gzip.open(p).read() == _golden_rawlog()


def _cross_frames(mod):
    pose0 = mod.MrptPose3D(np.zeros(3), np.array([1.0, 0, 0, 0]))
    scan = mod.MrptObservation(
        classname="CObservation2DRangeScan", sensor_label="laser", stamp=3.25, sensor_pose=pose0,
        aperture=float(np.pi), right_to_left=False, max_range=30.0,
        scan_ranges=np.array([1.5, 2.5, 3.5], np.float32), scan_validity=np.array([1, 0, 1], np.uint8),
    )
    cloud = mod.MrptObservation(
        classname="CObservationPointCloud", sensor_label="lidar", stamp=4.5, sensor_pose=pose0,
        points=np.random.default_rng(5).normal(size=(64, 3)).astype(np.float32),
    )
    return [[scan], [cloud]]


def _write(mod, kind, path):
    if kind == "simplemap":
        frames = _cross_frames(mod)
        entries = [mod.MrptSimpleMapEntry(mod.MrptPose3D(np.array([1.0, -2, 3]), np.array([1.0, 0, 0, 0])),
                                          0.02 * np.eye(6), frames[1], np.arange(6, dtype=np.float64))]
        mod.save_simplemap_mrpt(path, entries)
    elif kind == "mm":
        pts = np.random.default_rng(6).normal(size=(300, 3)).astype(np.float32)
        mod.save_metric_map_mrpt(path, {"localmap": (pts, None), "i": (pts[:7], np.arange(7, dtype=np.float32))})
    else:
        mod.write_rawlog(path, _cross_frames(mod))


def _read(mod, kind, path):
    if kind == "simplemap":
        return [(e.pose.t, e.cov, e.twist, [o.points for o in e.observations]) for e in mod.load_simplemap_mrpt(path)]
    if kind == "mm":
        return {k: v for k, v in mod.load_metric_map_mrpt(path).items()}
    return [[(o.classname, o.stamp, o.points, o.scan_ranges, o.scan_validity, o.right_to_left) for o in f]
            for f in mod.read_rawlog(path)]


def _assert_same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    elif a is None or b is None:
        assert a is None and b is None
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("kind", ["simplemap", "mm", "rawlog"])
def test_each_package_reads_the_others_file(tmp_path, kind):
    """Port writer -> JAX reader and JAX writer -> port reader: the same
    content, and the decompressed bytes of the two writers are equal."""
    p, pj = tmp_path / f"port.{kind}", tmp_path / f"jax.{kind}"
    _write(M, kind, p)
    _write(JM, kind, pj)
    assert gzip.open(p).read() == gzip.open(pj).read()
    _assert_same(_read(JM, kind, p), _read(M, kind, p))
    _assert_same(_read(M, kind, pj), _read(JM, kind, pj))
