"""Offline dataset readers (the L7 input layer).

Port of ``mola_lidar_odometry_tpu/apps/datasets.py``: the same readers,
frames equal bit for bit to the JAX package's.

TPU-framework counterparts of the ``mola_input_*`` packages consumed by the
reference CLI (reference apps/mola-lidar-odometry-cli.cpp:163-322 builds
KITTI / KITTI-360 / MulRan / Paris-LuCo / rawlog / rosbag2 sources; the
``OfflineDatasetSource`` contract is ``datasetSize()`` /
``datasetGetObservations(i)`` / ``hasGroundTruthTrajectory()``,
:442-479).

Each reader yields :class:`LidarFrame` records (numpy, host side) and an
optional ground-truth trajectory in TUM convention.  Directory layouts follow
the public datasets:

  * KITTI odometry:  ``$KITTI_BASE_DIR/sequences/<seq>/velodyne/*.bin``
    (x,y,z,intensity f32), ``times.txt``, ``calib.txt``;
    GT ``$KITTI_BASE_DIR/poses/<seq>.txt`` (cam0 frame, remapped by Tr).
    Includes the Deschaud-2018 vertical-angle correction (default 0.205 deg,
    reference apps/mola-lidar-odometry-cli.cpp:140-144,268-269).
  * KITTI-360:  ``$KITTI360_DATASET/data_3d_raw/<seq>/velodyne_points/``.
  * MulRan:  ``$MULRAN_BASE_DIR/<seq>/Ouster/<ns>.bin`` + ``global_pose.csv``.
  * Paris-LuCo:  ``$PARIS_LUCO_BASE_DIR/frames/frame_*.ply`` (binary PLY with
    per-point timestamps).
  * rawlog / rosbag2 / mcap readers are NATIVE since round 3: pure-Python
    CArchive parsing (utils/mrpt_io.py), sqlite3 ``.db3`` + CDR decoding
    (utils/rosbag2.py) and a pure-Python MCAP reader (utils/mcap.py) — no
    mrpt or rclpy bindings required.
  * ``SimDataset``: the bundled ray-cast simulator as a dataset source — the
    always-available stand-in for CI and demos.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclass
class LidarFrame:
    """One observation pulled from a dataset (host-side numpy)."""

    stamp: float
    xyz: np.ndarray  # (N, 3) f32, sensor frame
    times: Optional[np.ndarray] = None  # (N,) f32 per-point relative stamps
    intensity: Optional[np.ndarray] = None  # (N,) f32
    ring: Optional[np.ndarray] = None  # (N,) i32
    label: str = "lidar"


@dataclass
class GroundTruth:
    stamps: np.ndarray  # (F,)
    t: np.ndarray  # (F, 3)
    quat_xyzw: np.ndarray  # (F, 4)


class OfflineDataset:
    """Sequence of LidarFrames + optional ground truth."""

    label = "lidar"

    def __len__(self) -> int:
        raise NotImplementedError

    def get(self, i: int) -> LidarFrame:
        raise NotImplementedError

    def ground_truth(self) -> Optional[GroundTruth]:
        return None


def _estimate_scan_times(xyz: np.ndarray, spin_period: float = 0.1) -> np.ndarray:
    """Per-point relative timestamps from azimuth for spinning sensors whose
    format stores none (KITTI/MulRan .bin) — the same azimuth-model the
    reference's KITTI reader applies (generate_lidar_timestamps)."""
    az = np.arctan2(xyz[:, 1], xyz[:, 0])  # [-pi, pi), 0 = forward
    return (az / (2.0 * math.pi) * spin_period).astype(np.float32)


def _rot_to_quat_xyzw(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> quaternion (x, y, z, w)."""
    t = np.trace(R)
    if t > 0:
        s = math.sqrt(t + 1.0) * 2
        w = 0.25 * s
        x = (R[2, 1] - R[1, 2]) / s
        y = (R[0, 2] - R[2, 0]) / s
        z = (R[1, 0] - R[0, 1]) / s
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = math.sqrt(max(1e-12, 1.0 + R[i, i] - R[j, j] - R[k, k])) * 2
        q = [0.0, 0.0, 0.0]
        q[i] = 0.25 * s
        q[j] = (R[j, i] + R[i, j]) / s
        q[k] = (R[k, i] + R[i, k]) / s
        w = (R[k, j] - R[j, k]) / s
        x, y, z = q
    return np.asarray([x, y, z, w], np.float64)


class KittiOdometryDataset(OfflineDataset):
    """KITTI odometry benchmark reader (sequences 00-21)."""

    def __init__(
        self,
        sequence: str,
        base_dir: Optional[str] = None,
        vertical_angle_correction_deg: float = 0.205,
        clouds_in_vehicle_frame: bool = True,
    ):
        base_str = base_dir or os.environ.get("KITTI_BASE_DIR", "")
        base = Path(base_str)
        if not base_str or not base.exists():
            raise FileNotFoundError(
                f"KITTI base dir not found (set KITTI_BASE_DIR): {base!r}"
            )
        self.seq_dir = base / "sequences" / sequence
        self.bins = sorted((self.seq_dir / "velodyne").glob("*.bin"))
        if not self.bins:
            raise FileNotFoundError(f"no velodyne/*.bin under {self.seq_dir}")
        self.stamps = np.loadtxt(self.seq_dir / "times.txt", dtype=np.float64).reshape(-1)
        self.corr = math.radians(vertical_angle_correction_deg)
        self.calib = self._load_calib(self.seq_dir / "calib.txt")
        self.poses_file = base / "poses" / f"{sequence}.txt"
        self.clouds_in_vehicle_frame = clouds_in_vehicle_frame

    @staticmethod
    def _load_calib(path: Path) -> Dict[str, np.ndarray]:
        out = {}
        if path.exists():
            for line in path.read_text().splitlines():
                if ":" not in line:
                    continue
                k, v = line.split(":", 1)
                vals = np.fromstring(v, sep=" ")
                if vals.size == 12:
                    out[k.strip()] = vals.reshape(3, 4)
        return out

    def __len__(self) -> int:
        return len(self.bins)

    def get(self, i: int) -> LidarFrame:
        from mola_lidar_odometry_tpu_torch.utils import native

        if native.available():
            # native decode+correction+timestamps (overlappable via the
            # Prefetcher in high-throughput loops)
            cap = (self.bins[i].stat().st_size // 16) or 1
            xyz, inten, times, n = native.decode_bin(
                self.bins[i], cap, self.corr, 0.1
            )
            return LidarFrame(
                stamp=float(self.stamps[i]),
                xyz=xyz[:n], times=times[:n], intensity=inten[:n],
            )
        raw = np.fromfile(self.bins[i], np.float32).reshape(-1, 4)
        xyz, inten = raw[:, :3], raw[:, 3]
        if self.corr:
            # Deschaud (IMLS-SLAM, 2018): rotate each beam up by the fixed
            # intrinsic vertical-angle offset of the KITTI HDL-64
            r_xy = np.linalg.norm(xyz[:, :2], axis=1)
            el = np.arctan2(xyz[:, 2], r_xy) + self.corr
            rng = np.linalg.norm(xyz, axis=1)
            az = np.arctan2(xyz[:, 1], xyz[:, 0])
            xyz = np.stack(
                [
                    rng * np.cos(el) * np.cos(az),
                    rng * np.cos(el) * np.sin(az),
                    rng * np.sin(el),
                ],
                axis=1,
            ).astype(np.float32)
        return LidarFrame(
            stamp=float(self.stamps[i]),
            xyz=xyz,
            times=_estimate_scan_times(xyz),
            intensity=inten,
            label="lidar",
        )

    def ground_truth(self) -> Optional[GroundTruth]:
        if not self.poses_file.exists():
            return None
        P = np.loadtxt(self.poses_file).reshape(-1, 3, 4)  # cam0 poses
        Tr = self.calib.get("Tr")
        ts, qs = [], []
        for i in range(min(len(P), len(self.stamps))):
            T = np.eye(4)
            T[:3] = P[i]
            if Tr is not None:
                Tr4 = np.eye(4)
                Tr4[:3] = Tr
                T = np.linalg.inv(Tr4) @ T @ Tr4  # cam0 -> velodyne frame
            ts.append(T[:3, 3])
            qs.append(_rot_to_quat_xyzw(T[:3, :3]))
        n = len(ts)
        return GroundTruth(self.stamps[:n], np.asarray(ts), np.asarray(qs))


class Kitti360Dataset(OfflineDataset):
    """KITTI-360 raw velodyne reader."""

    def __init__(self, sequence: str, base_dir: Optional[str] = None):
        base_str = base_dir or os.environ.get("KITTI360_DATASET", "")
        base = Path(base_str)
        if not base_str or not base.exists():
            raise FileNotFoundError(
                f"KITTI-360 base dir not found (set KITTI360_DATASET): {base!r}"
            )
        name = sequence if "drive" in sequence else f"2013_05_28_drive_{int(sequence):04d}_sync"
        self.dir = base / "data_3d_raw" / name / "velodyne_points"
        self.bins = sorted((self.dir / "data").glob("*.bin"))
        if not self.bins:
            raise FileNotFoundError(f"no velodyne bins under {self.dir}")
        tfile = self.dir / "timestamps.txt"
        if tfile.exists():
            import datetime as _dt

            stamps = []
            for line in tfile.read_text().splitlines():
                line = line.strip()
                if not line:
                    continue
                d = _dt.datetime.fromisoformat(line[:26])
                stamps.append(d.timestamp())
            s = np.asarray(stamps)
            self.stamps = s - s[0]
        else:
            self.stamps = np.arange(len(self.bins)) * 0.1

    def __len__(self) -> int:
        return len(self.bins)

    def get(self, i: int) -> LidarFrame:
        raw = np.fromfile(self.bins[i], np.float32).reshape(-1, 4)
        xyz = raw[:, :3]
        return LidarFrame(
            stamp=float(self.stamps[i]),
            xyz=xyz,
            times=_estimate_scan_times(xyz),
            intensity=raw[:, 3],
        )

    def ground_truth(self) -> Optional[GroundTruth]:
        """KITTI-360 GT: data_poses/<drive>/poses.txt — 'frame r00..r23'
        rows (IMU/GNSS frame), sparse over frames."""
        gt_file = self.dir.parents[2] / "data_poses" / self.dir.parent.name / "poses.txt"
        if not gt_file.exists():
            return None
        rows = np.loadtxt(gt_file, ndmin=2)
        frames = rows[:, 0].astype(int)
        ok = frames < len(self.stamps)
        frames, rows = frames[ok], rows[ok]
        ts, qs = [], []
        for r in rows:
            T = r[1:13].reshape(3, 4)
            ts.append(T[:, 3])
            qs.append(_rot_to_quat_xyzw(T[:, :3]))
        return GroundTruth(self.stamps[frames], np.asarray(ts), np.asarray(qs))


class MulranDataset(OfflineDataset):
    """MulRan dataset reader (Ouster OS1-64 bins, ns-stamped filenames)."""

    def __init__(self, sequence: str, base_dir: Optional[str] = None):
        base_str = base_dir or os.environ.get("MULRAN_BASE_DIR", "")
        base = Path(base_str)
        if not base_str or not base.exists():
            raise FileNotFoundError(
                f"MulRan base dir not found (set MULRAN_BASE_DIR): {base!r}"
            )
        self.dir = base / sequence
        self.bins = sorted((self.dir / "Ouster").glob("*.bin"))
        if not self.bins:
            raise FileNotFoundError(f"no Ouster/*.bin under {self.dir}")
        ns = np.asarray([int(b.stem) for b in self.bins], np.float64)
        self.t0 = ns[0]
        self.stamps = (ns - ns[0]) * 1e-9
        self.gt_file = self.dir / "global_pose.csv"

    def __len__(self) -> int:
        return len(self.bins)

    def get(self, i: int) -> LidarFrame:
        raw = np.fromfile(self.bins[i], np.float32).reshape(-1, 4)
        xyz = raw[:, :3]
        return LidarFrame(
            stamp=float(self.stamps[i]),
            xyz=xyz,
            times=_estimate_scan_times(xyz),
            intensity=raw[:, 3],
        )

    def ground_truth(self) -> Optional[GroundTruth]:
        if not self.gt_file.exists():
            return None
        rows = np.loadtxt(self.gt_file, delimiter=",")
        stamps = (rows[:, 0] - self.t0) * 1e-9
        ts, qs = [], []
        for r in rows:
            T = r[1:13].reshape(3, 4)
            ts.append(T[:, 3])
            qs.append(_rot_to_quat_xyzw(T[:, :3]))
        return GroundTruth(stamps, np.asarray(ts), np.asarray(qs))


class ParisLucoDataset(OfflineDataset):
    """Paris-LuCo dataset reader (binary PLY frames with per-point stamps)."""

    def __init__(self, base_dir: Optional[str] = None):
        base_str = base_dir or os.environ.get("PARIS_LUCO_BASE_DIR", "")
        base = Path(base_str)
        if not base_str or not base.exists():
            raise FileNotFoundError(
                f"Paris-LuCo base dir not found (set PARIS_LUCO_BASE_DIR): {base!r}"
            )
        self.plys = sorted((base / "frames").glob("*.ply")) or sorted(base.glob("*.ply"))
        if not self.plys:
            raise FileNotFoundError(f"no *.ply frames under {base}")

    def __len__(self) -> int:
        return len(self.plys)

    @staticmethod
    def _read_ply(path: Path) -> Dict[str, np.ndarray]:
        with open(path, "rb") as f:
            if f.readline().strip() != b"ply":
                raise ValueError(f"{path}: not a PLY file")
            fields: List[Tuple[str, str]] = []
            count = 0
            fmt = "binary_little_endian"
            while True:
                line = f.readline().strip().decode()
                if line.startswith("format"):
                    fmt = line.split()[1]
                elif line.startswith("element vertex"):
                    count = int(line.split()[-1])
                elif line.startswith("property"):
                    _, typ, nm = line.split()
                    fields.append((nm, typ))
                elif line == "end_header":
                    break
            np_types = {
                "float": "f4", "float32": "f4", "double": "f8",
                "uchar": "u1", "uint8": "u1", "int": "i4", "int32": "i4",
                "uint": "u4", "uint32": "u4", "short": "i2", "ushort": "u2",
            }
            endian = "<" if "little" in fmt else ">"
            dt = np.dtype([(nm, endian + np_types[typ]) for nm, typ in fields])
            data = np.frombuffer(f.read(count * dt.itemsize), dtype=dt, count=count)
        return {nm: np.asarray(data[nm]) for nm, _ in fields}

    def get(self, i: int) -> LidarFrame:
        d = self._read_ply(self.plys[i])
        xyz = np.stack([d["x"], d["y"], d["z"]], 1).astype(np.float32)
        times = None
        for key in ("timestamp", "time", "t"):
            if key in d:
                tt = d[key].astype(np.float64)
                times = (tt - 0.5 * (tt.min() + tt.max())).astype(np.float32)
                break
        return LidarFrame(stamp=i * 0.1, xyz=xyz, times=times)


class RawlogDataset(OfflineDataset):
    """MRPT ``.rawlog`` reader — native pure-Python CArchive parsing
    (utils/mrpt_io.py), replacing the reference's mola_input_rawlog module
    (apps/mola-lidar-odometry-cli.cpp:404-410).  Supports observations-only
    and sensory-frame rawlogs carrying CObservationPointCloud /
    CObservation2DRangeScan entries; classes outside that set raise (MRPT
    streams carry no length framing, so unknown objects cannot be skipped —
    the format envelope is pinned in docs/mrpt_format.md)."""

    def __init__(self, path: str):
        from mola_lidar_odometry_tpu_torch.utils import mrpt_io as M

        self.frames = M.read_rawlog(path)

    def __len__(self) -> int:
        return len(self.frames)

    def get(self, i: int) -> LidarFrame:
        from mola_lidar_odometry_tpu_torch.utils import mrpt_io as M

        obs = None
        for o in self.frames[i]:
            if o.points is not None or o.scan_ranges is not None:
                obs = o
                break
        if obs is None:
            raise ValueError(f"rawlog frame {i} carries no supported scan")
        if obs.points is not None:
            xyz = np.asarray(obs.points, np.float32)
        else:
            # project the 2D scan into sensor-frame points (valid rays only);
            # MRPT beam spacing is endpoint-inclusive: ang_i = -ap/2 +
            # ap*i/(N-1) (mrpt CObservation2DRangeScan convention)
            n = len(obs.scan_ranges)
            span = obs.aperture
            ang = -span / 2.0 + span * np.arange(n) / max(n - 1, 1)
            if not obs.right_to_left:
                ang = ang[::-1]
            rr = np.asarray(obs.scan_ranges, np.float32)
            ok = np.asarray(obs.scan_validity, bool) & (rr > 0)
            xyz = np.stack(
                [rr * np.cos(ang), rr * np.sin(ang), np.zeros(n)], axis=1
            )[ok].astype(np.float32)
        if obs.sensor_pose is not None:
            R = obs.sensor_pose.R().astype(np.float32)
            xyz = xyz @ R.T + np.asarray(obs.sensor_pose.t, np.float32)
        return LidarFrame(stamp=float(obs.stamp), xyz=xyz, label=obs.sensor_label or "lidar")


class Rosbag2Dataset(OfflineDataset):
    """rosbag2 reader (reference input module mola_input_rosbag2).

    BOTH rosbag2 storage formats are read NATIVELY, no optional packages:
    ``.db3`` via pure-Python SQLite + CDR PointCloud2 decoding
    (utils/rosbag2.py) and ``.mcap`` via the pure-Python container parser
    (utils/mcap.py; zstd chunks handled, the reference's own test bag is
    mcap — reference test/test_lidar_odometry_rosbag2.cpp:113-143)."""

    def __init__(self, path: str, topic: Optional[str] = None):
        if str(path).endswith(".mcap"):
            from mola_lidar_odometry_tpu_torch.utils.mcap import McapReader

            self.reader = McapReader(str(path), topic)
        else:
            from mola_lidar_odometry_tpu_torch.utils.rosbag2 import Db3Reader

            self.reader = Db3Reader(str(path), topic)

    def __len__(self) -> int:
        return len(self.reader)

    def get(self, i: int) -> LidarFrame:
        bag_stamp, msg = self.reader.message(i)
        ch = msg.records()
        xyz = np.stack(
            [np.asarray(ch["x"], np.float32), np.asarray(ch["y"], np.float32),
             np.asarray(ch["z"], np.float32)],
            axis=-1,
        )
        finite = np.isfinite(xyz).all(axis=1)
        times = None
        for name in ("t", "time", "timestamp", "stamp", "time_stamp"):
            if name in ch:
                times = np.asarray(ch[name], np.float64)
                # vendors ship absolute ns / absolute s / relative s; reduce
                # to per-point RELATIVE seconds (FilterAdjustTimestamps
                # re-bases them anyway, reference pipelines do the same)
                if times.size and times.max() > 1e12:  # nanoseconds epoch
                    times = times * 1e-9
                if times.size:
                    times = times - times.min()
                times = times.astype(np.float32)
                break
        ring = (
            np.asarray(ch["ring"], np.int32) if "ring" in ch else None
        )
        inten = (
            np.asarray(ch["intensity"], np.float32)
            if "intensity" in ch
            else None
        )
        stamp = msg.stamp if msg.stamp > 0 else bag_stamp
        return LidarFrame(
            stamp=float(stamp),
            xyz=xyz[finite],
            times=None if times is None else times[finite],
            intensity=None if inten is None else inten[finite],
            ring=None if ring is None else ring[finite],
        )


class SimDataset(OfflineDataset):
    """The bundled ray-cast simulator as an offline dataset (with GT)."""

    def __init__(self, n_frames: int = 50, seed: int = 0, **kw):
        from mola_lidar_odometry_tpu_torch.utils import sim

        self.traj, self.scans = sim.simulate_sequence(
            n_frames, world_seed=seed, traj_seed=seed + 1, **kw
        )

    def __len__(self) -> int:
        return len(self.scans)

    def get(self, i: int) -> LidarFrame:
        xyz, times, rings, valid = self.scans[i]
        return LidarFrame(
            stamp=float(self.traj.stamps[i]),
            xyz=xyz[valid],
            times=times[valid],
            ring=rings[valid],
        )

    def ground_truth(self) -> GroundTruth:
        qs = np.stack([_rot_to_quat_xyzw(R) for R in self.traj.R])
        return GroundTruth(self.traj.stamps, self.traj.t, qs)
