"""Pure-Python MCAP (v1) rosbag2 container: reader + minimal writer.

Port of ``mola_lidar_odometry_tpu/utils/mcap.py``: a copy: both packages'
writers give the same bytes.

The reference's deskew regression test replays an ``.mcap`` fragment
(reference test/test_lidar_odometry_rosbag2.cpp:113-143,
test/CMakeLists.txt:57-65); its CLI accepts both ``.db3`` and ``.mcap``
bags (apps/mola-lidar-odometry-cli.cpp rosbag2 input).  The ``.db3`` path
already has a native pure-Python decoder (utils/rosbag2.py); this module
adds the MCAP container so both rosbag2 storage formats ingest without
optional packages.

Format (https://mcap.dev/spec — implemented from the public spec):
  file := magic, records..., magic;  magic = 0x89 "MCAP0" \\r \\n
  record := opcode u8, length u64le, body
  Schema(0x03)  := id u16, name str, encoding str, data(u32-prefixed bytes)
  Channel(0x04) := id u16, schema_id u16, topic str, message_encoding str,
                   metadata map<str,str>
  Message(0x05) := channel_id u16, sequence u32, log_time u64,
                   publish_time u64, data (rest of record)
  Chunk(0x06)   := start u64, end u64, uncompressed_size u64, crc u32,
                   compression str, records(u64-prefixed bytes)
  str := u32le length + utf8 bytes

Chunks may be zstd- or lz4-compressed; zstd is handled via the available
``zstandard`` package, uncompressed chunks natively, lz4 only when the
optional package exists.  CRCs are not validated (same stance as the
sqlite reader: the data either parses or raises).
"""

from __future__ import annotations

import struct
from typing import Dict, Iterator, List, Optional, Tuple

MAGIC = b"\x89MCAP0\r\n"

OP_HEADER = 0x01
OP_FOOTER = 0x02
OP_SCHEMA = 0x03
OP_CHANNEL = 0x04
OP_MESSAGE = 0x05
OP_CHUNK = 0x06
OP_DATA_END = 0x0F


class _R:
    """Little-endian cursor over a records buffer."""

    def __init__(self, buf: bytes, off: int = 0):
        self.buf = buf
        self.off = off

    def u8(self) -> int:
        v = self.buf[self.off]
        self.off += 1
        return v

    def u16(self) -> int:
        (v,) = struct.unpack_from("<H", self.buf, self.off)
        self.off += 2
        return v

    def u32(self) -> int:
        (v,) = struct.unpack_from("<I", self.buf, self.off)
        self.off += 4
        return v

    def u64(self) -> int:
        (v,) = struct.unpack_from("<Q", self.buf, self.off)
        self.off += 8
        return v

    def string(self) -> str:
        n = self.u32()
        s = self.buf[self.off : self.off + n]
        self.off += n
        return s.decode("utf-8", "replace")

    def raw(self, n: int) -> bytes:
        b = self.buf[self.off : self.off + n]
        self.off += n
        return b


def _decompress(compression: str, blob: bytes, out_size: int) -> bytes:
    if compression in ("", "none"):
        return blob
    if compression == "zstd":
        import zstandard

        return zstandard.ZstdDecompressor().decompress(blob, max_output_size=out_size)
    if compression == "lz4":
        try:
            import lz4.frame  # pragma: no cover - optional
        except ImportError as e:  # pragma: no cover
            raise ImportError("lz4-compressed mcap chunk needs the 'lz4' package") from e
        return lz4.frame.decompress(blob)  # pragma: no cover
    raise ValueError(f"unknown mcap chunk compression {compression!r}")


def _iter_records(buf: bytes, off: int, end: int) -> Iterator[Tuple[int, bytes]]:
    """Yield (opcode, body) over a records region, descending into chunks."""
    while off < end:
        op = buf[off]
        (length,) = struct.unpack_from("<Q", buf, off + 1)
        body_off = off + 9
        off = body_off + length
        if op == OP_CHUNK:
            r = _R(buf, body_off)
            r.u64()  # message_start_time
            r.u64()  # message_end_time
            usize = r.u64()
            r.u32()  # uncompressed_crc
            compression = r.string()
            rec_len = r.u64()
            inner = _decompress(compression, r.raw(rec_len), usize)
            yield from _iter_records(inner, 0, len(inner))
        elif op == OP_DATA_END or op == OP_FOOTER:
            return
        else:
            yield op, buf[body_off : body_off + length]


class McapMessage:
    __slots__ = ("topic", "log_time", "data", "schema_name")

    def __init__(self, topic: str, log_time: int, data: bytes, schema_name: str):
        self.topic = topic
        self.log_time = log_time
        self.data = data
        self.schema_name = schema_name


def read_messages(path: str, topic: Optional[str] = None) -> List[McapMessage]:
    """Parse an .mcap file and return its messages (optionally one topic),
    sorted by log time.  Loads the file into memory (bag fragments here are
    test/replay scale; the reference CLI also replays bags sequentially)."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:8] != MAGIC:
        raise ValueError(f"{path}: not an MCAP file")
    schemas: Dict[int, str] = {}
    channels: Dict[int, Tuple[str, int]] = {}  # id -> (topic, schema_id)
    out: List[McapMessage] = []
    for op, body in _iter_records(buf, 8, len(buf) - 8):
        if op == OP_SCHEMA:
            r = _R(body)
            sid = r.u16()
            schemas[sid] = r.string()
        elif op == OP_CHANNEL:
            r = _R(body)
            cid = r.u16()
            sid = r.u16()
            top = r.string()
            channels[cid] = (top, sid)
        elif op == OP_MESSAGE:
            r = _R(body)
            cid = r.u16()
            r.u32()  # sequence
            log_time = r.u64()
            r.u64()  # publish_time
            ch = channels.get(cid)
            if ch is None:
                continue
            top, sid = ch
            if topic is not None and top != topic:
                continue
            out.append(McapMessage(top, log_time, body[r.off :], schemas.get(sid, "")))
    out.sort(key=lambda m: m.log_time)
    return out


def list_topics(path: str) -> Dict[str, str]:
    """topic -> schema name map (for topic auto-selection)."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:8] != MAGIC:
        raise ValueError(f"{path}: not an MCAP file")
    schemas: Dict[int, str] = {}
    topics: Dict[str, str] = {}
    for op, body in _iter_records(buf, 8, len(buf) - 8):
        if op == OP_SCHEMA:
            r = _R(body)
            sid = r.u16()
            schemas[sid] = r.string()
        elif op == OP_CHANNEL:
            r = _R(body)
            r.u16()
            sid = r.u16()
            topics[r.string()] = schemas.get(sid, "")
    return topics


class McapReader:
    """PointCloud2-over-mcap reader with the Db3Reader interface
    (utils/rosbag2.py): ``len()`` + ``message(i) -> (stamp_s, PointCloud2)``."""

    def __init__(self, path: str, topic: Optional[str] = None):
        if topic is None:
            cand = [
                t
                for t, s in list_topics(path).items()
                if "PointCloud2" in s or not s
            ]
            if not cand:
                raise ValueError(f"{path}: no PointCloud2 topic found")
            topic = sorted(cand)[0]
        self.topic = topic
        self._msgs = read_messages(path, topic)
        if not self._msgs:
            raise ValueError(f"{path}: no messages on topic {topic!r}")

    def __len__(self) -> int:
        return len(self._msgs)

    def message(self, i: int):
        from mola_lidar_odometry_tpu_torch.utils.rosbag2 import parse_pointcloud2

        m = self._msgs[i]
        return m.log_time * 1e-9, parse_pointcloud2(m.data)


# ---------------------------------------------------------------------------
# minimal writer (tests / converters): uncompressed, no chunking, no index
# ---------------------------------------------------------------------------


def _record(op: int, body: bytes) -> bytes:
    return struct.pack("<BQ", op, len(body)) + body


def _s(s: str) -> bytes:
    b = s.encode("utf-8")
    return struct.pack("<I", len(b)) + b


def write_pointcloud2_mcap(path: str, frames, topic: str = "/points") -> None:
    """Write ``(stamp, xyz[, kwargs])`` frames as a PointCloud2 .mcap bag.

    ``frames`` matches utils/rosbag2.write_pointcloud2_db3's shape: tuples
    of ``(stamp_seconds, xyz)`` or ``(stamp_seconds, xyz, kwargs)`` where
    kwargs feeds encode_pointcloud2 (intensity/times/ring).  Output is
    spec-valid MCAP (unchunked, statistics-free) readable by this module
    and by standard mcap tooling.
    """
    from mola_lidar_odometry_tpu_torch.utils.rosbag2 import encode_pointcloud2

    parts = [MAGIC]
    header = _s("ros2") + _s("")  # profile, library
    parts.append(_record(OP_HEADER, header))
    schema = (
        struct.pack("<H", 1)
        + _s("sensor_msgs/msg/PointCloud2")
        + _s("ros2msg")
        + struct.pack("<I", 0)
    )
    parts.append(_record(OP_SCHEMA, schema))
    channel = (
        struct.pack("<HH", 1, 1) + _s(topic) + _s("cdr") + struct.pack("<I", 0)
    )
    parts.append(_record(OP_CHANNEL, channel))
    for seq, fr in enumerate(frames):
        stamp_s = fr[0]
        blob = encode_pointcloud2(*fr[:2], **(fr[2] if len(fr) > 2 else {}))
        t_ns = int(round(stamp_s * 1e9))
        body = struct.pack("<HIQQ", 1, seq, t_ns, t_ns) + blob
        parts.append(_record(OP_MESSAGE, body))
    parts.append(_record(OP_DATA_END, struct.pack("<I", 0)))
    # footer: no summary section (offsets 0), crc 0
    parts.append(_record(OP_FOOTER, struct.pack("<QQI", 0, 0, 0)))
    parts.append(MAGIC)
    with open(path, "wb") as f:
        f.write(b"".join(parts))
