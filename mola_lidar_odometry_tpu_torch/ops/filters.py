"""Point-cloud filters, batched over the fleet dimension.

Port of ``mola_lidar_odometry_tpu/ops/filters.py``: the voxel key and hash,
voxel decimation (FirstPoint and ClosestToAverage), range and bounding-box
splits, timestamp adjustment, deskew, intensity normalization and
selection, and the curvature and range-image edge masks.  Integer results
(hashes, decimation indices, masks) are bit-identical to the JAX package's.

The JAX filters see one instance; the masks that compare a point with its
neighbours in buffer order (``curvature_mask``, ``range_image_edge_mask``)
``jnp.roll`` over the instance's whole padded buffer, so here they roll
along the point axis of each instance, over its capacity: the tail wraps
into the head, padding included, as in the JAX package.
"""

from __future__ import annotations

from typing import Tuple

import torch

from mola_lidar_odometry_tpu_torch.ops import se3
from mola_lidar_odometry_tpu_torch.ops.pointcloud import PointCloud, gather_rows
from mola_lidar_odometry_tpu_torch.parallel.point_axis import all_max

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
    """Voxel-grid downsample (FilterDecimateVoxels).

    ``FirstPoint``: a stable sort on the voxel slot groups each voxel's
    points with the lowest input index first; run heads are the winners,
    and a second sort on ``loser_flag << shift | input_index`` emits the
    winners in INPUT order (decimation cascades, so input order is
    load-bearing).  ``ClosestToAverage``: see :func:`_closest_to_average`.
    If fewer than ``min_input_points`` points are valid the input passes
    through.  ``voxel_size`` may be a (B,) tensor (one resolution per
    instance)."""
    B, n = pc.valid.shape
    dev = pc.xyz.device
    vs = voxel_size.view(-1, 1, 1) if torch.is_tensor(voxel_size) else voxel_size
    slots = voxel_hash(voxel_coords(pc.xyz, vs), table_size)
    if method == "ClosestToAverage":
        keep = _closest_to_average(pc, slots, table_size)
        passthrough = (pc.count() < min_input_points)[:, None]
        return pc._replace(valid=torch.where(passthrough, pc.valid, keep)).compact(out_capacity)
    if method != "FirstPoint":
        raise ValueError(f"Unknown decimate method {method!r}")
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


def _sum_into(table: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor) -> None:
    """``table[idx] += vals`` in place, the same sums on every run.  On the
    CPU ``index_add_`` adds serially in input order, as XLA's CPU scatter
    does.  On CUDA ``index_add_`` adds with atomics in the order they land;
    ``index_put_(accumulate=True)`` sorts the indices and sums each run of
    duplicates in a fixed order (a warp's tree sum from 32 duplicates on),
    so a voxel's centroid does not move from run to run, though it may
    round apart from the CPU's."""
    if table.is_cuda:
        table.index_put_((idx,), vals, accumulate=True)
    else:
        table.index_add_(0, idx, vals)


def _closest_to_average(pc: PointCloud, slots: torch.Tensor, table_size: int) -> torch.Tensor:
    """The ClosestToAverage winners (B, n) bool: per hash slot the centroid
    of its valid points (a scatter-add on a flat 3-lane table), then the
    least squared distance to it (a scatter-min), and the first input index
    that reaches it wins (a second scatter-min).  Every instance owns
    ``table_size`` slots of one flat table.  The centroid sums are
    deterministic: see :func:`_sum_into`."""
    B, n = pc.valid.shape
    dev = pc.xyz.device
    T = table_size
    gslot = slots.to(torch.int64) + torch.arange(B, device=dev)[:, None] * T  # (B, n)
    idx3 = (gslot[..., None] * 3 + torch.arange(3, device=dev)).reshape(-1)
    ssum = torch.zeros((B * T * 3,), dtype=torch.float32, device=dev)
    _sum_into(ssum, idx3, torch.where(pc.valid[..., None], pc.xyz, 0.0).reshape(-1))
    scnt = torch.zeros((B * T,), dtype=torch.float32, device=dev)
    _sum_into(scnt, gslot.reshape(-1), pc.valid.to(torch.float32).reshape(-1))
    mean = ssum.view(B * T, 3)[gslot] / torch.clamp(scnt[gslot], min=1.0)[..., None]
    dlt = pc.xyz - mean
    d2 = se3.dot3(dlt, dlt)
    flat = gslot.reshape(-1)
    dist = torch.full((B * T,), torch.inf, dtype=torch.float32, device=dev)
    dist.scatter_reduce_(0, flat, torch.where(pc.valid, d2, torch.inf).reshape(-1), "amin")
    attains = pc.valid & (d2 <= dist[gslot])
    idx = torch.arange(n, dtype=torch.int32, device=dev).expand(B, n)
    cand = torch.where(attains, idx, n)
    first = torch.full((B * T,), n, dtype=torch.int32, device=dev)
    first.scatter_reduce_(0, flat, cand.reshape(-1), "amin")
    return pc.valid & (first[gslot] == idx)


def per_instance(v):
    """A float, or a (B,) tensor as a (B, 1) column against (B, n) data."""
    return v[:, None] if torch.is_tensor(v) and v.dim() else v


def filter_by_range(pc: PointCloud, range_min, range_max) -> Tuple[PointCloud, PointCloud]:
    """Split by sensor-frame range: (between, outside) layers (FilterByRange).
    ``range_min``/``range_max`` are floats or (B,) tensors."""
    x, y, z = pc.xyz.unbind(-1)
    r2 = x * x + y * y + z * z
    lo, hi = per_instance(range_min), per_instance(range_max)
    between = (r2 >= lo * lo) & (r2 <= hi * hi)
    return pc.with_mask(between), pc.with_mask(~between)


def filter_bounding_box(pc: PointCloud, bb_min, bb_max) -> Tuple[PointCloud, PointCloud]:
    """Split by axis-aligned box: (inside, outside) (FilterBoundingBox).
    ``bb_min``/``bb_max`` are (B, 3) tensors."""
    inside = torch.all((pc.xyz >= bb_min[:, None, :]) & (pc.xyz <= bb_max[:, None, :]), dim=-1)
    return pc.with_mask(inside), pc.with_mask(~inside)


def adjust_timestamps(pc: PointCloud, *, method: str = "MiddleIsZero", offset=0.0, axis=None) -> PointCloud:
    """Shift per-point timestamps (FilterAdjustTimestamps).  Under a point
    axis (``parallel/point_axis.py``) ``pc`` is this rank's slice and the
    scan's earliest and latest stamps are one all-reduce (max of -min, max
    and any)."""
    tmin = torch.amin(torch.where(pc.valid, pc.time, float("inf")), dim=-1)
    tmax = torch.amax(torch.where(pc.valid, pc.time, -float("inf")), dim=-1)
    any_valid = torch.any(pc.valid, dim=-1)
    if axis is not None:
        red = all_max(torch.stack([-tmin, tmax, any_valid.to(torch.float32)]), axis)
        tmin, tmax, any_valid = -red[0], red[1], red[2] > 0
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


def normalize_intensity(pc: PointCloud, axis=None) -> PointCloud:
    """Scale intensities into [0, 1] by the per-frame max
    (FilterNormalizeIntensity); under a point axis the max is all-reduced."""
    m = all_max(torch.amax(torch.where(pc.valid, pc.intensity, 0.0), dim=-1, keepdim=True), axis)
    return pc._replace(intensity=pc.intensity / torch.clamp(m, min=1e-12))


def filter_by_intensity(pc: PointCloud, low, high) -> PointCloud:
    """Keep points with intensity in [low, high] (FilterByIntensity);
    ``low``/``high`` are floats or (B,) tensors."""
    lo, hi = per_instance(low), per_instance(high)
    return pc.with_mask((pc.intensity >= lo) & (pc.intensity <= hi))


def curvature_mask(
    pc: PointCloud,
    *,
    max_cosine: float = 0.5,
    min_clearance: float = 0.02,
    max_gap: float = 1e9,
    window: int = 2,
) -> torch.Tensor:
    """High-curvature ("edge") mask (B, n) along scan order (FilterCurvature):
    the cosine of the angle between the vectors to the +/-``window``
    neighbours in buffer order within the same ring; edges have
    ``cos > -max_cosine``, points on straight lines ``cos ~ -1``.
    ``max_gap`` rejects neighbours farther than this (range
    discontinuities, not edges)."""
    prev = torch.roll(pc.xyz, window, dims=1)
    nxt = torch.roll(pc.xyz, -window, dims=1)
    ring_ok = (torch.roll(pc.ring, window, dims=1) == pc.ring) & (torch.roll(pc.ring, -window, dims=1) == pc.ring)
    a = prev - pc.xyz
    b = nxt - pc.xyz
    na, nb = torch.linalg.norm(a, dim=-1), torch.linalg.norm(b, dim=-1)
    cos = torch.sum(a * b, dim=-1) / torch.clamp(na * nb, min=1e-9)
    clear = (na > min_clearance) & (nb > min_clearance) & (na < max_gap) & (nb < max_gap)
    return (cos > -max_cosine) & clear & ring_ok


def filter_curvature(pc: PointCloud, **kw) -> PointCloud:
    """Keep high-curvature ("edge") points (FilterCurvature, larger side)."""
    return pc.with_mask(curvature_mask(pc, **kw))


def range_image_edge_mask(
    pc: PointCloud, *, score_threshold: float = 10.0, row_window_length: int = 6
) -> torch.Tensor:
    """Edge mask (B, n) over an organized scan (GeneratorEdgesFromRangeImage):
    points stored row-major with ``ring`` = row index; the LOAM-style score
    ``100 * sum_j |r_{i+j} - r_i| / r_i`` over the +/- half window within
    the same row."""
    r = torch.linalg.norm(pc.xyz, dim=-1)
    score = torch.zeros_like(r)
    in_row = torch.ones_like(pc.valid)
    for j in range(1, max(1, row_window_length // 2) + 1):
        for sgn in (-1, 1):
            rj = torch.roll(r, sgn * j, dims=1)
            vj = torch.roll(pc.valid, sgn * j, dims=1) & (torch.roll(pc.ring, sgn * j, dims=1) == pc.ring)
            score = score + torch.where(vj, torch.abs(rj - r), 0.0)
            in_row = in_row & vj
    rel = 100.0 * score / torch.clamp(r, min=1e-6)
    return pc.valid & in_row & (rel > score_threshold)
