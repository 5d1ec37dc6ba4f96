"""Point-cloud filters on the main path, batched over the fleet dimension.

Port of the subset of ``mola_lidar_odometry_tpu/ops/filters.py`` that the
lidar3d-default pipeline runs: the voxel key and hash, FirstPoint voxel
decimation, range and bounding-box splits, timestamp adjustment and deskew.
Integer results (hashes, decimation indices) are bit-identical to the JAX
package's.  The other filters are ROADMAP queue A item "other filters".
"""

from __future__ import annotations

from typing import Tuple

import torch

from mola_lidar_odometry_tpu_torch.ops import se3
from mola_lidar_odometry_tpu_torch.ops.pointcloud import PointCloud, gather_rows

# Spatial hash primes (standard Teschner et al. constants).
_HX, _HY, _HZ = 73856093, 19349663, 83492791
_M32 = 0xFFFFFFFF


def _wrap_i32(h: torch.Tensor) -> torch.Tensor:
    """int64 -> the int32 two's-complement wraparound of its low 32 bits."""
    h = h & _M32
    return torch.where(h >= 1 << 31, h - (1 << 32), h)


def voxel_coords(xyz: torch.Tensor, voxel_size) -> torch.Tensor:
    """Integer voxel coordinates: floor(x / voxel_size), (..., 3) i32.

    ``voxel_size`` is a Python float or a tensor broadcastable against
    ``xyz`` (a fleet passes ``(B, 1, 1)``)."""
    return torch.floor(xyz / voxel_size).to(torch.int32)


def voxel_hash(coords: torch.Tensor, table_size: int) -> torch.Tensor:
    """Horner-chained spatial hash of (..., 3) i32 coords into [0, table_size).

    Computed in int64 with an explicit int32 wrap after every step, which
    reproduces the JAX package's int32 wraparound arithmetic and its
    arithmetic ``>> 16`` bit for bit."""
    c = coords.to(torch.int64)
    h = _wrap_i32(c[..., 0] * _HX + c[..., 1])
    h = _wrap_i32(h * _HY + c[..., 2])
    h = _wrap_i32(h * _HZ)
    h = h ^ (h >> 16)
    return (h & (table_size - 1)).to(torch.int32)


def decimate_voxels(
    pc: PointCloud,
    voxel_size,
    out_capacity: int,
    *,
    method: str = "FirstPoint",
    min_input_points: int = 0,
    table_size: int = 1 << 19,
) -> PointCloud:
    """FirstPoint voxel-grid downsample (FilterDecimateVoxels).

    A stable sort on the voxel slot groups each voxel's points with the
    lowest input index first; run heads are the winners, and a second sort
    on ``loser_flag << shift | input_index`` emits the winners in INPUT
    order (decimation cascades, so input order is load-bearing).  If fewer
    than ``min_input_points`` points are valid the input passes through.
    ``voxel_size`` may be a (B,) tensor (one resolution per instance)."""
    if method != "FirstPoint":
        raise NotImplementedError(
            f"decimate method {method!r}: ROADMAP queue A, 'other filters'"
        )
    B, n = pc.valid.shape
    dev = pc.xyz.device
    vs = voxel_size.view(-1, 1, 1) if torch.is_tensor(voxel_size) else voxel_size
    slots = voxel_hash(voxel_coords(pc.xyz, vs), table_size)
    idx = torch.arange(n, dtype=torch.int32, device=dev).expand(B, n)
    key = torch.where(pc.valid, slots, table_size)
    skey, perm = torch.sort(key, dim=-1, stable=True)
    sidx = torch.gather(idx, -1, perm)
    first = torch.cat(
        [torch.ones((B, 1), dtype=torch.bool, device=dev), skey[:, 1:] != skey[:, :-1]], dim=-1
    ) & (skey < table_size)
    passthrough = (pc.count() < min_input_points)[:, None]
    winner = torch.where(passthrough, skey < table_size, first)
    shift = max(1, (n - 1).bit_length())
    k2 = torch.where(winner, 0, 1 << shift).to(torch.int32) | sidx
    k2s, _ = torch.sort(k2, dim=-1)
    sel = k2s & ((1 << shift) - 1)
    nw = torch.sum(winner.to(torch.int32), dim=-1)
    if out_capacity <= n:
        out_idx = sel[:, :out_capacity]
    else:
        out_idx = torch.nn.functional.pad(sel, (0, out_capacity - n))
    valid_out = torch.arange(out_capacity, device=dev)[None, :] < nw[:, None]
    packed = torch.cat(
        [pc.xyz, pc.time[..., None], pc.intensity[..., None], pc.ring.to(torch.float32)[..., None]],
        dim=-1,
    )  # (B, n, 6)
    g = torch.where(
        valid_out[..., None], gather_rows(packed, torch.where(valid_out, out_idx, 0)), 0.0
    )
    return PointCloud(
        xyz=g[..., :3],
        time=g[..., 3],
        intensity=g[..., 4],
        ring=g[..., 5].to(torch.int32),
        valid=valid_out,
    )


def filter_by_range(pc: PointCloud, range_min, range_max) -> Tuple[PointCloud, PointCloud]:
    """Split by sensor-frame range: (between, outside) layers (FilterByRange).
    ``range_min``/``range_max`` are floats or (B,) tensors."""
    x, y, z = pc.xyz.unbind(-1)
    r2 = x * x + y * y + z * z
    lo = range_min[:, None] if torch.is_tensor(range_min) else range_min
    hi = range_max[:, None] if torch.is_tensor(range_max) else range_max
    between = (r2 >= lo * lo) & (r2 <= hi * hi)
    return pc.with_mask(between), pc.with_mask(~between)


def filter_bounding_box(pc: PointCloud, bb_min, bb_max) -> Tuple[PointCloud, PointCloud]:
    """Split by axis-aligned box: (inside, outside) (FilterBoundingBox).
    ``bb_min``/``bb_max`` are (B, 3) tensors."""
    inside = torch.all((pc.xyz >= bb_min[:, None, :]) & (pc.xyz <= bb_max[:, None, :]), dim=-1)
    return pc.with_mask(inside), pc.with_mask(~inside)


def adjust_timestamps(pc: PointCloud, *, method: str = "MiddleIsZero", offset=0.0) -> PointCloud:
    """Shift per-point timestamps (FilterAdjustTimestamps)."""
    tmin = torch.amin(torch.where(pc.valid, pc.time, float("inf")), dim=-1)
    tmax = torch.amax(torch.where(pc.valid, pc.time, -float("inf")), dim=-1)
    any_valid = torch.any(pc.valid, dim=-1)
    tmin = torch.where(any_valid, tmin, 0.0)
    tmax = torch.where(any_valid, tmax, 0.0)
    if method == "MiddleIsZero":
        shift = 0.5 * (tmin + tmax)
    elif method == "EarliestIsZero":
        shift = tmin
    else:
        raise ValueError(f"Unknown timestamp method {method!r}")
    off = offset[:, None] if torch.is_tensor(offset) and offset.dim() else offset
    return pc._replace(time=torch.where(pc.valid, pc.time - shift[:, None] + off, pc.time))


def deskew(pc: PointCloud, twist: torch.Tensor, *, skip: bool = False) -> PointCloud:
    """Motion-compensate points with the (B, 6) body twist (FilterDeskew):
    each point at relative time dt moves to ``R(w*dt) p + v*dt``."""
    if skip:
        return pc
    v, w = twist[:, None, :3], twist[:, None, 3:]
    dt = pc.time[..., None]
    Rp = se3.so3_exp(w * dt)  # (B, N, 3, 3)
    # XLA fuses ``+ v * dt`` into the rotation's last multiply-add
    rot = se3.dot3(Rp, pc.xyz[..., None, :])
    xyz = se3.fma_f32(v.expand_as(rot), dt.expand_as(rot), rot)
    return pc._replace(xyz=torch.where(pc.valid[..., None], xyz, pc.xyz))
