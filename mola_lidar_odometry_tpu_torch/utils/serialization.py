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
loads here with the index rebuilt from its occupied voxels.  The MRPT
``.simplemap``/``.mm`` import and export wait for ROADMAP queue A, 'Host
surface'.
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
