"""MRPT-binary interop: CArchive streams, .simplemap / .mm / .rawlog.

Port of ``mola_lidar_odometry_tpu/utils/mrpt_io.py``: a copy (the port imports
nothing of the JAX package) whose writers give the same bytes.

The reference ecosystem persists its artifacts through MRPT serialization
(``mrpt::serialization::CArchive`` over ``CFileGZOutputStream``) — the
``.simplemap`` / ``.mm`` writers at reference
module/src/LidarOdometry.cpp:1865-1904 and the CRawlog datasets consumed by
apps/mola-lidar-odometry-cli.cpp:404-410.  Downstream tools (mm-viewer,
sm2mm, loop-closure postprocessing) read those binary containers, so a
framework swap needs exporters that speak the same format, not just NumPy
archives.

This module is a dependency-free (pure-Python + gzip) implementation of:

  * the **CArchive object framing** — each serialized object is
    ``int8(len(classname) | 0x80)``, the class-name bytes, ``int8 version``,
    the class payload, and an ``uint8 0x88`` end flag; a null pointer is the
    class name ``"nullptr"`` with no version/payload.  Streams written by
    ``CFileGZOutputStream`` are plain gzip (auto-detected on read).
  * the class payloads this framework needs: ``CPose3D``,
    ``CPose3DPDFGaussian``, ``CSensoryFrame``, ``CObservationPointCloud``,
    ``CObservation2DRangeScan`` (read), ``CSimplePointsMap`` /
    ``CPointsMapXYZI``, ``CSimpleMap``, and mp2p_icp's ``metric_map_t``.

**Fidelity note.**  The container framing above is the documented, stable
MRPT convention.  The per-class payload layouts are reconstructed from the
MRPT 2.x serialization sources to the best of available knowledge and are
pinned in docs/mrpt_format.md (field order, dtypes, version numbers); this
environment has no MRPT binaries to verify byte-for-byte against, so each
class reader/writer pair is validated by round-trip tests
(tests/test_mrpt_io.py) and the layout table is the contract to check the
day a real fixture is available.  Version numbers are chosen to match the
layout actually written, so a mismatched reader fails loudly on the version
byte rather than silently misparsing.
"""

from __future__ import annotations

import gzip
import io
import struct
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

SERIALIZATION_END_FLAG = 0x88

# MRPT TTimeStamp: 100 ns ticks since 1601-01-01 (FILETIME epoch)
_FILETIME_EPOCH_OFFSET_S = 11644473600


def unix_to_mrpt_timestamp(t: float) -> int:
    return int(round((t + _FILETIME_EPOCH_OFFSET_S) * 1e7))


def mrpt_timestamp_to_unix(ts: int) -> float:
    return ts * 1e-7 - _FILETIME_EPOCH_OFFSET_S


# ---------------------------------------------------------------------------
# archive primitives
# ---------------------------------------------------------------------------


class ArchiveWriter:
    def __init__(self, f):
        self.f = f

    def u8(self, v):
        self.f.write(struct.pack("<B", v & 0xFF))

    def i8(self, v):
        self.f.write(struct.pack("<b", v))

    def u32(self, v):
        self.f.write(struct.pack("<I", v))

    def i32(self, v):
        self.f.write(struct.pack("<i", v))

    def u64(self, v):
        self.f.write(struct.pack("<Q", v))

    def f32(self, v):
        self.f.write(struct.pack("<f", v))

    def f64(self, v):
        self.f.write(struct.pack("<d", v))

    def string(self, s: str):
        b = s.encode("utf-8")
        self.u32(len(b))
        self.f.write(b)

    def f32_vector(self, a: np.ndarray):
        a = np.asarray(a, "<f4").ravel()
        self.u32(len(a))
        self.f.write(a.tobytes())

    def f64_array(self, a: np.ndarray):
        self.f.write(np.asarray(a, "<f8").ravel().tobytes())

    def begin_object(self, classname: str, version: int):
        b = classname.encode("ascii")
        if len(b) > 0x7F:
            raise ValueError("class name too long")
        self.i8((len(b) | 0x80) - 0x100)  # int8 with the new-format high bit
        self.f.write(b)
        self.i8(version)

    def end_object(self):
        self.u8(SERIALIZATION_END_FLAG)

    def null_object(self):
        b = b"nullptr"
        self.i8((len(b) | 0x80) - 0x100)
        self.f.write(b)
        self.u8(SERIALIZATION_END_FLAG)


class ArchiveReader:
    def __init__(self, f):
        self.f = f

    def _read(self, n) -> bytes:
        b = self.f.read(n)
        if len(b) != n:
            raise EOFError("archive truncated")
        return b

    def u8(self):
        return struct.unpack("<B", self._read(1))[0]

    def i8(self):
        return struct.unpack("<b", self._read(1))[0]

    def u32(self):
        return struct.unpack("<I", self._read(4))[0]

    def i32(self):
        return struct.unpack("<i", self._read(4))[0]

    def u64(self):
        return struct.unpack("<Q", self._read(8))[0]

    def f32(self):
        return struct.unpack("<f", self._read(4))[0]

    def f64(self):
        return struct.unpack("<d", self._read(8))[0]

    def string(self) -> str:
        return self._read(self.u32()).decode("utf-8")

    def f32_vector(self) -> np.ndarray:
        n = self.u32()
        return np.frombuffer(self._read(4 * n), "<f4").copy()

    def f64_array(self, n) -> np.ndarray:
        return np.frombuffer(self._read(8 * n), "<f8").copy()

    def begin_object(self) -> Tuple[Optional[str], int]:
        """Returns (classname, version); (None, 0) for a nullptr entry
        (its end flag is consumed here)."""
        lenflag = self.i8()
        if lenflag >= 0:
            raise ValueError(
                "old-format (pre-1.0) MRPT object framing is not supported"
            )
        name = self._read(lenflag & 0x7F).decode("ascii")
        if name == "nullptr":
            self.end_object()
            return None, 0
        version = self.i8()
        return name, version

    def end_object(self):
        flag = self.u8()
        if flag != SERIALIZATION_END_FLAG:
            raise ValueError(f"bad end-of-object flag 0x{flag:02x}")


# ---------------------------------------------------------------------------
# plain data holders (host-side views of the serialized classes)
# ---------------------------------------------------------------------------


@dataclass
class MrptPose3D:
    t: np.ndarray  # (3,) f64
    quat_wxyz: np.ndarray  # (4,) f64  [qr, qx, qy, qz]

    @staticmethod
    def from_R_t(R: np.ndarray, t: np.ndarray) -> "MrptPose3D":
        return MrptPose3D(np.asarray(t, np.float64), rot_to_quat_wxyz(R))

    def R(self) -> np.ndarray:
        return quat_wxyz_to_rot(self.quat_wxyz)


@dataclass
class MrptObservation:
    classname: str
    sensor_label: str = ""
    stamp: float = 0.0
    sensor_pose: Optional[MrptPose3D] = None
    points: Optional[np.ndarray] = None  # (N, 3) f32 for point-cloud obs
    intensity: Optional[np.ndarray] = None
    # 2D range scan fields
    scan_ranges: Optional[np.ndarray] = None
    scan_validity: Optional[np.ndarray] = None
    aperture: float = 0.0
    right_to_left: bool = True
    max_range: float = 0.0


@dataclass
class MrptSimpleMapEntry:
    pose: MrptPose3D
    cov: np.ndarray  # (6, 6) f64
    observations: List[MrptObservation] = field(default_factory=list)
    twist: Optional[np.ndarray] = None  # (6,) f64


def rot_to_quat_wxyz(R: np.ndarray) -> np.ndarray:
    R = np.asarray(R, np.float64)
    tr = np.trace(R)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        qr = 0.25 * s
        qx = (R[2, 1] - R[1, 2]) / s
        qy = (R[0, 2] - R[2, 0]) / s
        qz = (R[1, 0] - R[0, 1]) / s
    elif R[0, 0] > R[1, 1] and R[0, 0] > R[2, 2]:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
        qr = (R[2, 1] - R[1, 2]) / s
        qx = 0.25 * s
        qy = (R[0, 1] + R[1, 0]) / s
        qz = (R[0, 2] + R[2, 0]) / s
    elif R[1, 1] > R[2, 2]:
        s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
        qr = (R[0, 2] - R[2, 0]) / s
        qx = (R[0, 1] + R[1, 0]) / s
        qy = 0.25 * s
        qz = (R[1, 2] + R[2, 1]) / s
    else:
        s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
        qr = (R[1, 0] - R[0, 1]) / s
        qx = (R[0, 2] + R[2, 0]) / s
        qy = (R[1, 2] + R[2, 1]) / s
        qz = 0.25 * s
    q = np.array([qr, qx, qy, qz])
    return q / np.linalg.norm(q)


def quat_wxyz_to_rot(q: np.ndarray) -> np.ndarray:
    qr, qx, qy, qz = np.asarray(q, np.float64) / np.linalg.norm(q)
    return np.array(
        [
            [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qr * qz), 2 * (qx * qz + qr * qy)],
            [2 * (qx * qy + qr * qz), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qr * qx)],
            [2 * (qx * qz - qr * qy), 2 * (qy * qz + qr * qx), 1 - 2 * (qx * qx + qy * qy)],
        ]
    )


# ---------------------------------------------------------------------------
# class payloads (layouts pinned in docs/mrpt_format.md)
# ---------------------------------------------------------------------------


def write_pose3d(w: ArchiveWriter, p: MrptPose3D):
    """mrpt::poses::CPose3D v2: 7 doubles [x y z qr qx qy qz]."""
    w.begin_object("CPose3D", 2)
    w.f64_array(np.concatenate([p.t, p.quat_wxyz]))
    w.end_object()


def read_pose3d(r: ArchiveReader) -> MrptPose3D:
    name, ver = r.begin_object()
    if name != "CPose3D":
        raise ValueError(f"expected CPose3D, got {name}")
    if ver < 2:
        raise ValueError(f"CPose3D v{ver} (pre-quaternion) not supported")
    vals = r.f64_array(7)
    r.end_object()
    return MrptPose3D(vals[:3], vals[3:])


def write_pose3d_pdf_gaussian(w: ArchiveWriter, p: MrptPose3D, cov: np.ndarray):
    """mrpt::poses::CPose3DPDFGaussian v1: framed CPose3D mean + 6x6 f64
    covariance (row-major, [x y z yaw pitch roll] tangent order)."""
    w.begin_object("CPose3DPDFGaussian", 1)
    write_pose3d(w, p)
    w.f64_array(np.asarray(cov, np.float64).reshape(6, 6))
    w.end_object()


def read_pose3d_pdf_gaussian(r: ArchiveReader) -> Tuple[MrptPose3D, np.ndarray]:
    name, ver = r.begin_object()
    if name != "CPose3DPDFGaussian":
        raise ValueError(f"expected CPose3DPDFGaussian, got {name}")
    mean = read_pose3d(r)
    cov = r.f64_array(36).reshape(6, 6)
    r.end_object()
    return mean, cov


def write_points_map(
    w: ArchiveWriter, pts: np.ndarray, intensity: Optional[np.ndarray] = None
):
    """mrpt::maps::CSimplePointsMap / CPointsMapXYZI v0: three f32 vectors
    (x, y, z), each with its own uint32 count; XYZI appends an intensity
    vector."""
    pts = np.asarray(pts, np.float32).reshape(-1, 3)
    cls = "CPointsMapXYZI" if intensity is not None else "CSimplePointsMap"
    w.begin_object(cls, 0)
    w.f32_vector(pts[:, 0])
    w.f32_vector(pts[:, 1])
    w.f32_vector(pts[:, 2])
    if intensity is not None:
        w.f32_vector(np.asarray(intensity, np.float32).ravel())
    w.end_object()


def read_points_map(r: ArchiveReader) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    name, ver = r.begin_object()
    if name not in ("CSimplePointsMap", "CPointsMapXYZI", "CPointsMapXYZIRT"):
        raise ValueError(f"unsupported points map class {name}")
    xs = r.f32_vector()
    ys = r.f32_vector()
    zs = r.f32_vector()
    intensity = None
    times = None
    if name in ("CPointsMapXYZI", "CPointsMapXYZIRT"):
        intensity = r.f32_vector()
    if name == "CPointsMapXYZIRT":
        _ring = r.f32_vector()
        times = r.f32_vector()  # noqa: F841 — parsed, not yet surfaced
    r.end_object()
    return np.stack([xs, ys, zs], axis=1), intensity


def write_observation_pointcloud(w: ArchiveWriter, obs: MrptObservation):
    """mrpt::obs::CObservationPointCloud v0: sensorLabel, timestamp,
    framed sensorPose, framed point cloud."""
    w.begin_object("CObservationPointCloud", 0)
    w.string(obs.sensor_label)
    w.u64(unix_to_mrpt_timestamp(obs.stamp))
    write_pose3d(w, obs.sensor_pose or MrptPose3D(np.zeros(3), np.array([1.0, 0, 0, 0])))
    if obs.points is None:
        w.null_object()
    else:
        write_points_map(w, obs.points, obs.intensity)
    w.end_object()


def _read_observation_pointcloud(r: ArchiveReader, ver: int) -> MrptObservation:
    label = r.string()
    ts = r.u64()
    pose = read_pose3d(r)
    peek = r.begin_object()
    if peek[0] is None:
        pts, inten = None, None
    else:
        # re-dispatch: we already consumed the header, parse the body inline
        name = peek[0]
        xs = r.f32_vector()
        ys = r.f32_vector()
        zs = r.f32_vector()
        inten = None
        if name in ("CPointsMapXYZI", "CPointsMapXYZIRT"):
            inten = r.f32_vector()
        if name == "CPointsMapXYZIRT":
            r.f32_vector()
            r.f32_vector()
        r.end_object()
        pts = np.stack([xs, ys, zs], axis=1)
    r.end_object()
    return MrptObservation(
        classname="CObservationPointCloud",
        sensor_label=label,
        stamp=mrpt_timestamp_to_unix(ts),
        sensor_pose=pose,
        points=pts,
        intensity=inten,
    )


def write_observation_2d_scan(w: ArchiveWriter, obs: MrptObservation):
    """mrpt::obs::CObservation2DRangeScan v0 (this module's layout):
    sensorLabel, timestamp, framed sensorPose, aperture f64,
    rightToLeft u8, maxRange f64, ranges f32 vector, validity u8 per ray."""
    w.begin_object("CObservation2DRangeScan", 0)
    w.string(obs.sensor_label)
    w.u64(unix_to_mrpt_timestamp(obs.stamp))
    write_pose3d(w, obs.sensor_pose or MrptPose3D(np.zeros(3), np.array([1.0, 0, 0, 0])))
    w.f64(obs.aperture)
    w.u8(1 if obs.right_to_left else 0)
    w.f64(obs.max_range)
    w.f32_vector(obs.scan_ranges)
    val = np.asarray(obs.scan_validity, np.uint8)
    w.u32(len(val))
    w.f.write(val.tobytes())
    w.end_object()


def _read_observation_2d_scan(r: ArchiveReader, ver: int) -> MrptObservation:
    label = r.string()
    ts = r.u64()
    pose = read_pose3d(r)
    aperture = r.f64()
    rtl = r.u8() != 0
    max_range = r.f64()
    ranges = r.f32_vector()
    nv = r.u32()
    validity = np.frombuffer(r._read(nv), np.uint8).copy()
    r.end_object()
    return MrptObservation(
        classname="CObservation2DRangeScan",
        sensor_label=label,
        stamp=mrpt_timestamp_to_unix(ts),
        sensor_pose=pose,
        aperture=aperture,
        right_to_left=rtl,
        max_range=max_range,
        scan_ranges=ranges,
        scan_validity=validity,
    )


_OBS_READERS = {
    "CObservationPointCloud": _read_observation_pointcloud,
    "CObservation2DRangeScan": _read_observation_2d_scan,
}


def read_observation(r: ArchiveReader) -> Optional[MrptObservation]:
    name, ver = r.begin_object()
    if name is None:
        return None
    fn = _OBS_READERS.get(name)
    if fn is None:
        raise ValueError(
            f"unsupported observation class {name!r} — MRPT streams carry no "
            "per-object length, so unknown classes cannot be skipped"
        )
    return fn(r, ver)


def write_sensory_frame(w: ArchiveWriter, observations: List[MrptObservation]):
    """mrpt::obs::CSensoryFrame v2: uint32 count + framed observations."""
    w.begin_object("CSensoryFrame", 2)
    w.u32(len(observations))
    for o in observations:
        if o.classname == "CObservationPointCloud":
            write_observation_pointcloud(w, o)
        elif o.classname == "CObservation2DRangeScan":
            write_observation_2d_scan(w, o)
        else:
            raise ValueError(f"cannot serialize observation class {o.classname}")
    w.end_object()


def read_sensory_frame(r: ArchiveReader) -> List[MrptObservation]:
    n = r.u32()
    obs = [read_observation(r) for _ in range(n)]
    r.end_object()
    return [o for o in obs if o is not None]


# ---------------------------------------------------------------------------
# top-level containers
# ---------------------------------------------------------------------------


def _open_write(path) -> io.BufferedWriter:
    return gzip.open(str(path), "wb")  # CFileGZOutputStream = plain gzip


def _open_read(path):
    f = open(str(path), "rb")
    magic = f.read(2)
    f.seek(0)
    if magic == b"\x1f\x8b":
        return gzip.open(f)
    return f


def save_simplemap_mrpt(path: Union[str, Path], entries: List[MrptSimpleMapEntry]):
    """Write an MRPT ``.simplemap``: one framed CSimpleMap (v1: uint32 count,
    then per keyframe a framed CPose3DPDFGaussian + framed CSensoryFrame;
    the per-KF twist rides in a trailing f64[6] per entry, v1 extension)."""
    with _open_write(path) as f:
        w = ArchiveWriter(f)
        w.begin_object("CSimpleMap", 1)
        w.u32(len(entries))
        for e in entries:
            write_pose3d_pdf_gaussian(w, e.pose, e.cov)
            write_sensory_frame(w, e.observations)
            tw = e.twist if e.twist is not None else np.zeros(6)
            w.f64_array(np.asarray(tw, np.float64))
        w.end_object()


def load_simplemap_mrpt(path: Union[str, Path]) -> List[MrptSimpleMapEntry]:
    with _open_read(path) as f:
        r = ArchiveReader(f)
        name, ver = r.begin_object()
        if name != "CSimpleMap":
            raise ValueError(f"not a simplemap stream (top object {name})")
        n = r.u32()
        out = []
        for _ in range(n):
            pose, cov = read_pose3d_pdf_gaussian(r)
            name2, _ = r.begin_object()
            if name2 != "CSensoryFrame":
                raise ValueError(f"expected CSensoryFrame, got {name2}")
            obs = read_sensory_frame(r)
            twist = r.f64_array(6) if ver >= 1 else np.zeros(6)
            out.append(MrptSimpleMapEntry(pose, cov, obs, twist))
        r.end_object()
        return out


def save_metric_map_mrpt(
    path: Union[str, Path], layers: Dict[str, Tuple[np.ndarray, Optional[np.ndarray]]]
):
    """Write an mp2p_icp ``.mm``: framed metric_map_t (v0: uint32 layer
    count, then per layer a string name + framed points map).  Structured
    map layers (voxel hash / NDT / occupancy) export as their point view —
    the representation every downstream consumer (mm-viewer, sm2mm) renders
    anyway."""
    with _open_write(path) as f:
        w = ArchiveWriter(f)
        w.begin_object("metric_map_t", 0)
        w.u32(len(layers))
        for name, (pts, inten) in layers.items():
            w.string(name)
            write_points_map(w, pts, inten)
        w.end_object()


def load_metric_map_mrpt(
    path: Union[str, Path]
) -> Dict[str, Tuple[np.ndarray, Optional[np.ndarray]]]:
    with _open_read(path) as f:
        r = ArchiveReader(f)
        name, _ = r.begin_object()
        if name != "metric_map_t":
            raise ValueError(f"not a metric_map_t stream (top object {name})")
        n = r.u32()
        out = {}
        for _ in range(n):
            lname = r.string()
            out[lname] = read_points_map(r)
        r.end_object()
        return out


def read_rawlog(path: Union[str, Path]) -> List[List[MrptObservation]]:
    """Read an MRPT ``.rawlog`` stream: a sequence of framed top-level
    objects.  Supports the observations-only format (CObservation* entries,
    one frame each) and the sensory-frame format (CSensoryFrame entries);
    CActionCollection entries between frames are not supported (no
    odometry-action datasets here).  Returns a list of frames, each a list
    of observations."""
    frames: List[List[MrptObservation]] = []
    with _open_read(path) as f:
        r = ArchiveReader(f)
        while True:
            try:
                name, ver = r.begin_object()
            except EOFError:
                break
            if name is None:
                continue
            if name == "CSensoryFrame":
                frames.append(read_sensory_frame(r))
            elif name in _OBS_READERS:
                frames.append([_OBS_READERS[name](r, ver)])
            else:
                raise ValueError(
                    f"unsupported rawlog entry {name!r} (streams carry no "
                    "length framing; cannot skip unknown classes)"
                )
    return frames


def write_rawlog(path: Union[str, Path], frames: List[List[MrptObservation]]):
    """Write an observations-only / sensory-frame ``.rawlog`` stream."""
    with _open_write(path) as f:
        w = ArchiveWriter(f)
        for obs_list in frames:
            if len(obs_list) == 1:
                o = obs_list[0]
                if o.classname == "CObservationPointCloud":
                    write_observation_pointcloud(w, o)
                else:
                    write_observation_2d_scan(w, o)
            else:
                write_sensory_frame(w, obs_list)
