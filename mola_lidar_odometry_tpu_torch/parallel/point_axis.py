"""The point axis: one scan's points split over a group of ranks.

Counterpart of the ``point`` mesh axis of the JAX package's
``parallel/batch.py::make_sharded_fleet_step``.  There GSPMD inserts the
collectives; here they are written by hand with ``torch.distributed`` and
kept in this module.  A :class:`PointAxis` names the process group of one
fleet row, this process's rank in it and its size; it is passed down the
step explicitly.  ``None`` means no point axis, and every function here is
then the identity (or the one-device computation), so a step without a
point axis runs the code it ran before.

A layer that holds this rank's slice of the scan is a :class:`PointSlice`;
every other layer is whole, the same on every rank of the row.  Per-point
filters keep a slice a slice (``PointCloud._replace`` keeps the type);
whatever reduces over the whole scan either all-reduces
(:func:`all_max`, :func:`all_sum`, :func:`all_any`) or gathers the layer
first (:func:`gather_cloud`, :func:`gather_compact`), in rank order, which
is the padded scan's point order.

Each collective is counted on the axis (calls and the bytes of its result,
as ``eval/shard_cost.py`` counts the JAX package's collectives from the
compiled program); :meth:`PointAxis.take_counts` reads and clears them.
Over ``gloo`` (two ranks on one card, or the CPU) CUDA tensors go through
the host; over ``nccl`` they stay on the card.
"""

from __future__ import annotations

import collections
from typing import Any, Dict, Optional, Tuple

import torch

from mola_lidar_odometry_tpu_torch.ops.pointcloud import PointCloud


class PointAxis:
    """One fleet row's point group: ``group`` (a ``torch.distributed``
    process group), this process's ``rank`` in it and its ``size``.
    ``via_host`` stages CUDA tensors through the host (a ``gloo`` group)."""

    def __init__(self, group: Any, rank: int, size: int, via_host: bool = False):
        self.group, self.rank, self.size, self.via_host = group, rank, size, via_host
        self.counts: Dict[str, list] = collections.defaultdict(lambda: [0, 0])

    def _count(self, kind: str, nbytes: int) -> None:
        c = self.counts[kind]
        c[0] += 1
        c[1] += int(nbytes)

    def take_counts(self) -> Dict[str, Tuple[int, int]]:
        """``{kind: (calls, bytes)}`` since the last call, and clear them."""
        out = {k: tuple(v) for k, v in self.counts.items()}
        self.counts.clear()
        return out


class PointSlice(PointCloud):
    """A layer of which this rank holds its slice of the scan's points
    (the ranks' slices concatenated in rank order are the whole layer)."""

    __slots__ = ()


def _staged(t: torch.Tensor, axis: PointAxis) -> torch.Tensor:
    return t.cpu() if axis.via_host and t.is_cuda else t


def _all_reduce(t: torch.Tensor, axis: PointAxis, op, kind: str) -> torch.Tensor:
    import torch.distributed as dist

    x = _staged(t, axis).clone().contiguous()
    dist.all_reduce(x, op=op, group=axis.group)
    axis._count(kind, x.numel() * x.element_size())
    return x.to(t.device)


def all_max(t: torch.Tensor, axis: Optional[PointAxis]) -> torch.Tensor:
    """Elementwise max over the ranks (exact)."""
    if axis is None:
        return t
    import torch.distributed as dist

    return _all_reduce(t, axis, dist.ReduceOp.MAX, "all_reduce")


def all_sum(t: torch.Tensor, axis: Optional[PointAxis]) -> torch.Tensor:
    """Elementwise sum over the ranks; every rank gets the same values."""
    if axis is None:
        return t
    import torch.distributed as dist

    return _all_reduce(t, axis, dist.ReduceOp.SUM, "all_reduce")


def all_any(t: torch.Tensor, axis: Optional[PointAxis]) -> torch.Tensor:
    """Elementwise ``or`` of a bool tensor over the ranks."""
    if axis is None:
        return t
    return all_max(t.to(torch.int32), axis) > 0


def gather_points(t: torch.Tensor, axis: Optional[PointAxis], dim: int = 1) -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``dim`` in rank order (the
    shapes must agree)."""
    if axis is None:
        return t
    import torch.distributed as dist

    x = _staged(t, axis).contiguous()
    parts = [torch.empty_like(x) for _ in range(axis.size)]
    dist.all_gather(parts, x, group=axis.group)
    out = torch.cat(parts, dim=dim)
    axis._count("all_gather", out.numel() * out.element_size())
    return out.to(t.device)


def scatter_offsets(count: torch.Tensor, axis: Optional[PointAxis]) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(offsets, counts)``, each ``count.shape + (P,)``: every rank's
    ``count`` in rank order and their exclusive prefix sum, where rank r's
    entries start in a layer packed in rank order."""
    counts = gather_points(count[..., None], axis, dim=-1)
    return torch.cumsum(counts, dim=-1) - counts, counts


def own_rows(t: torch.Tensor, axis: Optional[PointAxis], dim: int = 1) -> torch.Tensor:
    """This rank's rows of a whole tensor: the ``rank``-th of ``size``
    equal parts along ``dim`` (the size must divide)."""
    if axis is None:
        return t
    n = t.shape[dim]
    if n % axis.size:
        raise ValueError(f"own_rows: {n} rows do not divide over a point axis of {axis.size}")
    k = n // axis.size
    return t.narrow(dim, axis.rank * k, k)


def _packed(pc: PointCloud) -> torch.Tensor:
    """(B, n, 7) f32: xyz, time, intensity, ring, valid (ring < 2**24)."""
    return torch.cat([pc.xyz, pc.time[..., None], pc.intensity[..., None],
                      pc.ring.to(torch.float32)[..., None], pc.valid.to(torch.float32)[..., None]], dim=-1)


def _unpacked(g: torch.Tensor) -> PointCloud:
    return PointCloud(xyz=g[..., :3], time=g[..., 3], intensity=g[..., 4], ring=g[..., 5].to(torch.int32),
                      valid=g[..., 6] > 0)


def gather_cloud(pc: PointCloud, axis: Optional[PointAxis]) -> PointCloud:
    """The whole layer of a :class:`PointSlice`: every rank's padded slice
    in rank order (one all-gather).  A whole layer passes through."""
    if axis is None or not isinstance(pc, PointSlice):
        return pc
    return _unpacked(gather_points(_packed(pc), axis, dim=1))


def gather_compact(pc: PointCloud, capacity: int, axis: Optional[PointAxis]) -> PointCloud:
    """``gather_cloud(pc).compact(capacity)`` without gathering the padding:
    each rank packs its valid points (in order) into the prefix of a buffer
    as long as the most any rank holds (one host read), the buffers are
    all-gathered, and rank r's points land at its exclusive offset, those
    past ``capacity`` dropped, as the one-device compaction truncates."""
    if axis is None or not isinstance(pc, PointSlice):
        return pc.compact(capacity)
    B, dev = pc.valid.shape[0], pc.xyz.device
    offsets, counts = scatter_offsets(pc.count(), axis)  # (B, P) each
    m = max(int(counts.max()), 1)
    blocks = gather_points(_packed(pc.compact(m))[:, None], axis, dim=1)  # (B, P, m, 7)
    pos = offsets[..., None] + torch.arange(m, device=dev)  # (B, P, m)
    keep = (torch.arange(m, device=dev) < counts[..., None]) & (pos < capacity)
    out = torch.zeros((B, capacity + 1, 7), dtype=torch.float32, device=dev)
    b = torch.arange(B, device=dev)[:, None, None].expand_as(pos)
    out[b, torch.where(keep, pos, capacity)] = torch.where(keep[..., None], blocks, 0.0)
    return _unpacked(out[:, :capacity])


def _words(t: torch.Tensor) -> torch.Tensor:
    """(B, -1) int64 of a tensor's 32-bit words (narrower types widened)."""
    B = t.shape[0]
    if t.element_size() == 1:
        w = t.to(torch.int32)
    elif t.element_size() == 2:
        w = t.view(torch.int16).to(torch.int32)
    else:
        w = t.contiguous().view(torch.int32)
    return w.reshape(B, -1).to(torch.int64)


def _tensors(x):
    if torch.is_tensor(x):
        yield x
    elif isinstance(x, tuple):
        for y in x:
            yield from _tensors(y)


def map_hash(maps: Dict[str, Any]) -> torch.Tensor:
    """(B,) int64: a position-weighted sum of every 32-bit word of every map
    tensor, modulo 2**64 (integer sums, so the same on every run)."""
    h = None
    for name in sorted(maps):
        for t in _tensors(maps[name]):
            w = _words(t)
            pos = torch.arange(w.shape[1], dtype=torch.int64, device=w.device) * 2654435761 + 40503
            v = torch.sum(w * pos, dim=1)
            h = v if h is None else h * 1000003 + v
    return h


def check_replicas(maps: Dict[str, Any], axis: Optional[PointAxis]) -> Optional[torch.Tensor]:
    """The ranks' map hashes ``(B, P)`` (one all-gather); raises if the
    ranks' replicas of the carry's maps differ.  ``None`` without an axis."""
    if axis is None:
        return None
    hashes = gather_points(map_hash(maps)[:, None], axis, dim=1)
    if not bool(torch.all(hashes == hashes[:, :1])):
        raise RuntimeError(f"point axis: the map replicas differ across the point ranks: {hashes.tolist()}")
    return hashes
