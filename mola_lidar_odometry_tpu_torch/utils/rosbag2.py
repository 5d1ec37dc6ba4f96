"""Pure-Python rosbag2 ``.db3`` reader for ``sensor_msgs/msg/PointCloud2``.

Port of ``mola_lidar_odometry_tpu/utils/rosbag2.py``: a copy: both packages'
encoders write the same bytes.

Counterpart of the reference's rosbag2 input module (gated behind
``HAVE_MOLA_INPUT_ROSBAG2``; reference apps/mola-lidar-odometry-cli.cpp
rosbag2 path + mola_input_rosbag2 package).  The reference links the ROS 2
C++ stack; none of it exists in this environment — but the on-disk format
does not need it:

  * a rosbag2 SQLite bag is two tables —
    ``topics(id, name, type, serialization_format, offered_qos_profiles)``
    and ``messages(id, topic_id, timestamp, data)``;
  * each message blob is XCDR-encoded: a 4-byte encapsulation header
    (representation id + options) followed by the fields of
    ``sensor_msgs/msg/PointCloud2`` with standard CDR alignment.

This module decodes exactly that, with numpy doing the point-record
unpacking via a structured dtype built from the message's own
``PointField`` descriptions.  Channel mapping mirrors the reference's
per-vendor handling: per-point time from any of ``t``/``time``/
``timestamp``/``stamp``, ring from ``ring``, intensity from ``intensity``.

``write_pointcloud2_db3`` produces the same format (schema + CDR) and
exists so the reader is *executable and tested* in this environment —
reference test strategy: test/test_lidar_odometry_rosbag2.cpp drives the
pipeline from a recorded bag.
"""

from __future__ import annotations

import sqlite3
import struct
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

# sensor_msgs/msg/PointField datatype codes -> numpy dtypes
_PF_DTYPES = {
    1: np.int8, 2: np.uint8, 3: np.int16, 4: np.uint16,
    5: np.int32, 6: np.uint32, 7: np.float32, 8: np.float64,
}
_PC2_TYPE = "sensor_msgs/msg/PointCloud2"


class _Cdr:
    """Minimal XCDR1 little-endian decoder (alignment relative to the
    payload start, i.e. after the 4-byte encapsulation header)."""

    def __init__(self, blob: bytes):
        if len(blob) < 4:
            raise ValueError("CDR blob too short")
        rep = struct.unpack_from("<H", blob, 0)[0]
        if rep not in (0x0000, 0x0100, 0x0001):  # CDR_BE/CDR_LE variants
            raise ValueError(f"unsupported CDR representation 0x{rep:04x}")
        self.buf = blob
        self.pos = 4  # payload origin

    def _align(self, size: int) -> None:
        off = (self.pos - 4) % size
        if off:
            self.pos += size - off

    def u8(self) -> int:
        v = self.buf[self.pos]
        self.pos += 1
        return v

    def u32(self) -> int:
        self._align(4)
        v = struct.unpack_from("<I", self.buf, self.pos)[0]
        self.pos += 4
        return v

    def i32(self) -> int:
        self._align(4)
        v = struct.unpack_from("<i", self.buf, self.pos)[0]
        self.pos += 4
        return v

    def string(self) -> str:
        n = self.u32()  # length INCLUDING the null terminator
        s = self.buf[self.pos : self.pos + max(n - 1, 0)].decode("utf-8", "replace")
        self.pos += n
        return s

    def bytes_seq(self) -> bytes:
        n = self.u32()
        b = self.buf[self.pos : self.pos + n]
        self.pos += n
        return b


@dataclass
class PointCloud2:
    stamp: float  # seconds
    frame_id: str
    height: int
    width: int
    fields: List[Tuple[str, int, int, int]]  # (name, offset, datatype, count)
    point_step: int
    data: bytes

    def records(self) -> Dict[str, np.ndarray]:
        """Decode the point blob into named channel arrays (length H*W)."""
        names, formats, offsets = [], [], []
        for name, off, dt, cnt in self.fields:
            np_dt = _PF_DTYPES.get(dt)
            if np_dt is None or cnt != 1:
                continue
            names.append(name)
            formats.append(np_dt)
            offsets.append(off)
        dtype = np.dtype(
            {"names": names, "formats": formats, "offsets": offsets,
             "itemsize": self.point_step}
        )
        n = self.height * self.width
        arr = np.frombuffer(self.data, dtype=dtype, count=n)
        return {name: arr[name] for name in names}


def parse_pointcloud2(blob: bytes) -> PointCloud2:
    c = _Cdr(blob)
    sec = c.i32()
    nsec = c.u32()
    frame_id = c.string()
    height = c.u32()
    width = c.u32()
    nfields = c.u32()
    fields = []
    for _ in range(nfields):
        name = c.string()
        off = c.u32()
        dt = c.u8()
        cnt = c.u32()
        fields.append((name, off, dt, cnt))
    c.u8()  # is_bigendian
    point_step = c.u32()
    c.u32()  # row_step
    data = c.bytes_seq()
    return PointCloud2(
        stamp=sec + nsec * 1e-9,
        frame_id=frame_id,
        height=height,
        width=width,
        fields=fields,
        point_step=point_step,
        data=data,
    )


class Db3Reader:
    """Iterate PointCloud2 messages of one topic in a rosbag2 SQLite bag."""

    def __init__(self, path: str, topic: Optional[str] = None):
        self.db = sqlite3.connect(f"file:{path}?mode=ro", uri=True)
        rows = self.db.execute(
            "SELECT id, name, type FROM topics"
        ).fetchall()
        clouds = [r for r in rows if r[2] == _PC2_TYPE]
        if topic is not None:
            clouds = [r for r in clouds if r[1] == topic]
        if not clouds:
            have = ", ".join(f"{r[1]} ({r[2]})" for r in rows) or "none"
            raise ValueError(
                f"no {_PC2_TYPE} topic"
                + (f" named {topic!r}" if topic else "")
                + f" in bag; topics: {have}"
            )
        self.topic_id, self.topic, _ = clouds[0]
        self.count = self.db.execute(
            "SELECT COUNT(*) FROM messages WHERE topic_id=?", (self.topic_id,)
        ).fetchone()[0]

    def __len__(self) -> int:
        return self.count

    def message(self, i: int) -> Tuple[float, PointCloud2]:
        row = self.db.execute(
            "SELECT timestamp, data FROM messages WHERE topic_id=? "
            "ORDER BY timestamp LIMIT 1 OFFSET ?",
            (self.topic_id, i),
        ).fetchone()
        if row is None:
            raise IndexError(i)
        bag_stamp_ns, blob = row
        return bag_stamp_ns * 1e-9, parse_pointcloud2(blob)


# ---------------------------------------------------------------------------
# Writer (rosbag2-compatible schema + CDR) — lets the reader be tested and
# lets the simulator export bags other ROS 2 tools can open.
# ---------------------------------------------------------------------------


class _CdrW:
    def __init__(self):
        self.parts = bytearray(struct.pack("<HH", 0x0001, 0x0000))

    def _align(self, size: int) -> None:
        off = (len(self.parts) - 4) % size
        if off:
            self.parts += b"\x00" * (size - off)

    def u8(self, v: int):
        self.parts.append(v & 0xFF)

    def u32(self, v: int):
        self._align(4)
        self.parts += struct.pack("<I", v)

    def i32(self, v: int):
        self._align(4)
        self.parts += struct.pack("<i", v)

    def string(self, s: str):
        b = s.encode("utf-8") + b"\x00"
        self.u32(len(b))
        self.parts += b

    def bytes_seq(self, b: bytes):
        self.u32(len(b))
        self.parts += b


def encode_pointcloud2(
    stamp: float,
    xyz: np.ndarray,
    *,
    intensity: Optional[np.ndarray] = None,
    times: Optional[np.ndarray] = None,
    ring: Optional[np.ndarray] = None,
    frame_id: str = "lidar",
) -> bytes:
    """CDR-encode one PointCloud2 (x,y,z[,intensity][,t][,ring] f32/u16)."""
    n = len(xyz)
    fields = [("x", 0, 7, 1), ("y", 4, 7, 1), ("z", 8, 7, 1)]
    step = 12
    chans: List[Tuple[np.ndarray, np.dtype]] = []
    if intensity is not None:
        fields.append(("intensity", step, 7, 1))
        chans.append((np.asarray(intensity, np.float32), np.float32))
        step += 4
    if times is not None:
        fields.append(("t", step, 7, 1))
        chans.append((np.asarray(times, np.float32), np.float32))
        step += 4
    if ring is not None:
        fields.append(("ring", step, 4, 1))
        chans.append((np.asarray(ring, np.uint16), np.uint16))
        step += 2
        step += step % 4  # keep records 4-aligned like real drivers do
    rec = np.zeros(n, dtype=np.dtype({"names": [f[0] for f in fields],
                                      "formats": [_PF_DTYPES[f[2]] for f in fields],
                                      "offsets": [f[1] for f in fields],
                                      "itemsize": step}))
    rec["x"], rec["y"], rec["z"] = (
        np.asarray(xyz[:, 0], np.float32),
        np.asarray(xyz[:, 1], np.float32),
        np.asarray(xyz[:, 2], np.float32),
    )
    for (name, *_), (vals, _dt) in zip(fields[3:], chans):
        rec[name] = vals
    w = _CdrW()
    sec = int(stamp)
    w.i32(sec)
    w.u32(int(round((stamp - sec) * 1e9)))
    w.string(frame_id)
    w.u32(1)  # height
    w.u32(n)  # width
    w.u32(len(fields))
    for name, off, dt, cnt in fields:
        w.string(name)
        w.u32(off)
        w.u8(dt)
        w.u32(cnt)
    w.u8(0)  # is_bigendian
    w.u32(step)
    w.u32(step * n)
    w.bytes_seq(rec.tobytes())
    w.u8(1)  # is_dense
    return bytes(w.parts)


def write_pointcloud2_db3(path: str, frames, topic: str = "/points") -> None:
    """Write (stamp, xyz[, intensity, times, ring]) frames as a rosbag2 .db3."""
    db = sqlite3.connect(path)
    db.executescript(
        """
        CREATE TABLE topics(
          id INTEGER PRIMARY KEY, name TEXT NOT NULL, type TEXT NOT NULL,
          serialization_format TEXT NOT NULL, offered_qos_profiles TEXT NOT NULL);
        CREATE TABLE messages(
          id INTEGER PRIMARY KEY, topic_id INTEGER NOT NULL,
          timestamp INTEGER NOT NULL, data BLOB NOT NULL);
        """
    )
    db.execute(
        "INSERT INTO topics VALUES (1, ?, ?, 'cdr', '')", (topic, _PC2_TYPE)
    )
    for i, fr in enumerate(frames):
        stamp = fr[0]
        blob = encode_pointcloud2(*fr[:2], **(fr[2] if len(fr) > 2 else {}))
        db.execute(
            "INSERT INTO messages VALUES (?, 1, ?, ?)",
            (i + 1, int(round(stamp * 1e9)), blob),
        )
    db.commit()
    db.close()
