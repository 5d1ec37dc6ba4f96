"""Map and simple-map serialization.

Port of ``mola_lidar_odometry_tpu/utils/serialization.py:23-157``, in the
same ``.npz`` file format, so a local map or a simple-map saved by one
package loads in the other:

  * ``*.mm.npz`` — the local map's layers: per layer ``<name>/voxel_size``
    (scalar f32), ``<name>/data`` ((rows, 128) i32, the JAX table layout word
    for word) and ``<name>/epoch`` (scalar i32), an NDT layer also
    ``<name>/max_eigen_ratio`` (scalar f32), plus a JSON ``__meta__`` with
    each layer's class and a point map's static ``K`` and ``stride``; an
    occupancy layer (kind ``"OccupancyMap"``) holds ``keys``, ``used``,
    ``logodds`` and the five log-odds scalars under the JAX field names, and
    its match index as a point map under ``<name>/match/``;
  * ``*.simplemap.npz`` — keyframed trajectory and raw scans, the scans
    optionally externalized to ``<name>_Images/scan_*.bin`` for lazy load.

A port map carries a leading fleet dimension; the file holds one instance
(B = 1), without it.  The JAX package's loader reads an occupancy layer's
fields from such a file but not its match index (its ``save_metric_map``
cannot write one: ROADMAP C9); an occupancy layer without ``match/`` arrays
loads here with the index rebuilt from its occupied voxels.

The MRPT ``.simplemap``/``.mm`` export and import (``:158-251`` of the JAX
module) write the same bytes through the port's copy of ``mrpt_io``; the
metric-map export takes instance 0 of a one-instance map and copies its
point view to the host once.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Union

import numpy as np
import torch

from mola_lidar_odometry_tpu_torch.ops import occupancy
from mola_lidar_odometry_tpu_torch.ops.ndt import NdtMap
from mola_lidar_odometry_tpu_torch.ops.occupancy import OccupancyMap
from mola_lidar_odometry_tpu_torch.ops.voxel_hash import VoxelHashMap


def _npz_path(path: Union[str, Path]) -> str:
    """The path ``np.savez`` writes: '.npz' appended unless present (a
    literal existing path is kept for loading)."""
    p = str(path)
    if p.endswith(".npz") or Path(p).exists():
        return p
    return p + ".npz"


def save_metric_map(path: Union[str, Path], maps: Dict[str, object]) -> None:
    """Persist the local map layers (the '.mm' analogue) of one instance."""
    arrays, meta = {}, {}

    def put(prefix, m):
        if m.voxel_size.shape[0] != 1:
            raise ValueError(f"save_metric_map: layer {prefix!r} holds {m.voxel_size.shape[0]} instances, the file holds one")
        for fld in m._fields:
            v = getattr(m, fld)
            if torch.is_tensor(v):
                arrays[f"{prefix}/{fld}"] = v[0].cpu().numpy()

    for name, m in maps.items():
        if isinstance(m, VoxelHashMap):
            meta[name] = {"kind": "VoxelHashMap", "K": int(m.K), "stride": int(m.stride)}
        elif isinstance(m, OccupancyMap):
            meta[name] = {"kind": "OccupancyMap", "match": {"K": int(m.match.K), "stride": int(m.match.stride)}}
            put(f"{name}/match", m.match)
        else:
            meta[name] = {"kind": type(m).__name__}
        put(name, m)
    np.savez_compressed(_npz_path(path), __meta__=json.dumps(meta), **arrays)


def load_metric_map(path: Union[str, Path], device="cuda") -> Dict[str, object]:
    """Load a '.mm.npz' → dict of one-instance layers on ``device``."""
    d = np.load(_npz_path(path), allow_pickle=False)
    meta = json.loads(str(d["__meta__"]))
    out = {}
    for name, info in meta.items():

        def arr(fld, dtype):
            return torch.as_tensor(np.asarray(d[f"{name}/{fld}"]), dtype=dtype, device=device)[None]

        f32, i32 = torch.float32, torch.int32
        if info["kind"] == "VoxelHashMap":
            out[name] = VoxelHashMap(
                voxel_size=arr("voxel_size", f32), data=arr("data", i32),
                epoch=arr("epoch", i32), K=int(info["K"]), stride=int(info["stride"]),
            )
        elif info["kind"] == "NdtMap":
            out[name] = NdtMap(
                voxel_size=arr("voxel_size", f32), max_eigen_ratio=arr("max_eigen_ratio", f32),
                data=arr("data", i32), epoch=arr("epoch", i32),
            )
        elif info["kind"] == "OccupancyMap":
            vs, keys = arr("voxel_size", f32), arr("keys", i32)
            if f"{name}/match/data" in d:
                match = VoxelHashMap(
                    voxel_size=arr("match/voxel_size", f32), data=arr("match/data", i32),
                    epoch=arr("match/epoch", i32), K=int(info["match"]["K"]), stride=int(info["match"]["stride"]),
                )
            else:
                match = VoxelHashMap.create(keys.shape[1], OccupancyMap.MATCH_POINTS_PER_VOXEL, 1.0, 1, device)
                match = match._replace(voxel_size=vs * OccupancyMap.MATCH_GRID_FACTOR)
            m = OccupancyMap(
                voxel_size=vs, keys=keys, used=arr("used", torch.bool), logodds=arr("logodds", f32), match=match,
                **{f: arr(f, f32) for f in ("l_hit", "l_miss", "l_min", "l_max", "l_occ")},
            )
            out[name] = m if f"{name}/match/data" in d else occupancy.rebuild_match(m)[0]
        else:
            raise ValueError(f"unknown map layer kind {info['kind']!r}")
    return out


def save_simplemap(path: Union[str, Path], keyframes: List, lazy_load: bool = False) -> None:
    path = Path(_npz_path(path))
    arrays, meta = {}, []
    ext_dir = path.parent / (path.stem + "_Images")
    if lazy_load:
        ext_dir.mkdir(exist_ok=True)
    for i, kf in enumerate(keyframes):
        entry = {
            "stamp": kf.stamp,
            "t": kf.t.tolist(),
            "quat_xyzw": kf.quat_xyzw.tolist(),
            "twist": kf.twist.tolist(),
            "has_scan": kf.scan_xyz is not None,
            "gnss": kf.gnss or {},
            "metadata": kf.metadata or {},
        }
        if kf.scan_xyz is not None:
            if lazy_load:
                ext = ext_dir / f"scan_{i:06d}.bin"
                kf.scan_xyz.astype(np.float32).tofile(ext)
                entry["scan_path"] = str(ext)
            else:
                arrays[f"scan_{i:06d}"] = kf.scan_xyz.astype(np.float32)
        meta.append(entry)
    np.savez_compressed(str(path), meta=json.dumps(meta), **arrays)


def load_simplemap(path: Union[str, Path]) -> List:
    from mola_lidar_odometry_tpu_torch.models.odometry import SimpleMapKeyframe

    d = np.load(_npz_path(path), allow_pickle=False)
    meta = json.loads(str(d["meta"]))
    out = []
    for i, e in enumerate(meta):
        scan = None
        key = f"scan_{i:06d}"
        if e.get("has_scan"):
            if key in d:
                scan = d[key]
            elif e.get("scan_path") and Path(e["scan_path"]).exists():
                scan = np.fromfile(e["scan_path"], np.float32).reshape(-1, 3)
        out.append(
            SimpleMapKeyframe(
                stamp=e["stamp"],
                t=np.asarray(e["t"]),
                quat_xyzw=np.asarray(e["quat_xyzw"]),
                twist=np.asarray(e["twist"]),
                scan_xyz=scan,
                scan_path=e.get("scan_path"),
                gnss=e.get("gnss") or None,
                metadata=e.get("metadata") or None,
            )
        )
    return out


# ---------------------------------------------------------------------------
# MRPT-binary interop (reference-toolchain consumable; utils/mrpt_io.py)
# ---------------------------------------------------------------------------


def export_simplemap_mrpt(path: Union[str, Path], keyframes: List) -> None:
    """Write the keyframe list as an MRPT ``.simplemap`` (gzip CArchive),
    the container the reference ecosystem's sm2mm / mm-viewer / loop-closure
    tools consume (reference module/src/LidarOdometry.cpp:1865-1904)."""
    from mola_lidar_odometry_tpu_torch.utils import mrpt_io as M

    entries = []
    for kf in keyframes:
        q = np.asarray(kf.quat_xyzw, np.float64)
        pose = M.MrptPose3D(np.asarray(kf.t, np.float64), np.array([q[3], q[0], q[1], q[2]]))  # xyzw -> wxyz
        obs = []
        scan = kf.scan_xyz
        if scan is None and kf.scan_path and Path(kf.scan_path).exists():
            scan = np.fromfile(kf.scan_path, np.float32).reshape(-1, 3)
        if scan is not None:
            obs.append(
                M.MrptObservation(
                    classname="CObservationPointCloud",
                    sensor_label="lidar",
                    stamp=float(kf.stamp),
                    sensor_pose=M.MrptPose3D(np.zeros(3), np.array([1.0, 0, 0, 0])),
                    points=np.asarray(scan, np.float32),
                )
            )
        entries.append(
            M.MrptSimpleMapEntry(
                pose=pose, cov=np.zeros((6, 6)), observations=obs, twist=np.asarray(kf.twist, np.float64)
            )
        )
    M.save_simplemap_mrpt(path, entries)


def import_simplemap_mrpt(path: Union[str, Path]) -> List:
    """Read an MRPT ``.simplemap`` back into SimpleMapKeyframe objects."""
    from mola_lidar_odometry_tpu_torch.models.odometry import SimpleMapKeyframe
    from mola_lidar_odometry_tpu_torch.utils import mrpt_io as M

    out = []
    for e in M.load_simplemap_mrpt(path):
        q = e.pose.quat_wxyz
        scan = None
        stamp = 0.0
        for o in e.observations:
            stamp = o.stamp or stamp
            if o.points is not None:
                scan = o.points
        out.append(
            SimpleMapKeyframe(
                stamp=stamp,
                t=np.asarray(e.pose.t),
                quat_xyzw=np.array([q[1], q[2], q[3], q[0]]),
                twist=np.asarray(e.twist if e.twist is not None else np.zeros(6)),
                scan_xyz=scan,
            )
        )
    return out


def metric_map_points(maps, capacity: int = 1 << 20, anchor=None) -> Dict[str, np.ndarray]:
    """Each layer of a one-instance local map flattened to its live points
    (voxel contents / NDT means / occupied centers), as ``{layer: (N, 3)
    f32}`` on the host: instance 0's point views, copied in one transfer.

    ``anchor`` (3,) world position (e.g. the robot pose at save time, an
    array or a tensor) pins the wrapped-voxel-key unwrap of point maps;
    without it the anchor is derived from each map's own live keys."""
    from mola_lidar_odometry_tpu_torch.ops import maps as maps_ops

    if not isinstance(maps, dict):
        maps = {"localmap": maps}
    views = []
    for m in maps.values():
        a = None
        if anchor is not None:
            a = torch.as_tensor(anchor, dtype=torch.float32, device=m.voxel_size.device).view(1, 3)
        pc = maps_ops.as_pointcloud(m, capacity, anchor=a)
        views.append(torch.cat([pc.xyz[0], pc.valid[0, :, None].to(torch.float32)], dim=-1))
    host = torch.stack(views).cpu().numpy() if views else np.zeros((0, capacity, 4), np.float32)
    return {name: v[v[:, 3] > 0, :3].astype(np.float32) for name, v in zip(maps, host)}


def export_metric_map_mrpt(path: Union[str, Path], maps, capacity: int = 1 << 20, anchor=None) -> None:
    """Write the local map as an mp2p_icp ``.mm`` (gzip CArchive), each
    layer flattened to its point view (:func:`metric_map_points`)."""
    from mola_lidar_odometry_tpu_torch.utils import mrpt_io as M

    layers = {name: (xyz, None) for name, xyz in metric_map_points(maps, capacity, anchor).items()}
    M.save_metric_map_mrpt(path, layers)


def import_metric_map_mrpt(path: Union[str, Path]):
    """Read an mp2p_icp ``.mm`` into {layer: (N,3) points} arrays."""
    from mola_lidar_odometry_tpu_torch.utils import mrpt_io as M

    return {k: pts for k, (pts, _) in M.load_metric_map_mrpt(path).items()}
