"""Occupancy voxel map with ray-traced free space (log-odds), batched over the fleet.

Port of ``mola_lidar_odometry_tpu/ops/occupancy.py``: the map of the lidar2d
pipeline (reference ``mrpt::maps::CVoxelMap``, pipelines/lidar2d.yaml:
``resolution``, ``prob_hit``/``prob_miss``, ``clamp_min``/``clamp_max``,
``ray_trace_free_space``, ``remove_voxels_farther_than``,
``occupiedThreshold``).  The state keeps the JAX fields, each with a leading
fleet dimension B, so the two packages' maps compare word for word:

  * a direct-mapped table of ``V`` slots: ``keys (B, V, 3)`` int32 voxel
    coords, ``used (B, V)`` (the slot owns a voxel, free or occupied) and
    ``logodds (B, V)`` float32;
  * ``match``, a :class:`~.voxel_hash.VoxelHashMap` (K = 32) of the
    occupied voxel centers on a grid ``MATCH_GRID_FACTOR`` times coarser,
    rebuilt on every insert: the matcher's candidates come from it;
  * the five log-odds scalars as (B,) tensors.

An insert walks every beam from the sensor with the exact Amanatides-Woo
DDA (the same float recurrence as the JAX ``lax.scan``, step by step),
adds the miss log-odds to every voxel crossed before ``range - voxel/2``,
then the hit log-odds to the endpoint voxels, and clamps.  Within one pass
every addend of a slot is the same value, so the sequential sums come out
equal in any order: ``index_add_`` gives the JAX package's log-odds bit for
bit on the CPU, and with the card's atomics too.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from mola_lidar_odometry_tpu_torch.ops import se3, voxel_hash as vh
from mola_lidar_odometry_tpu_torch.ops.filters import voxel_coords, voxel_hash
from mola_lidar_odometry_tpu_torch.ops.pointcloud import PointCloud, gather_rows, on_device


def _logit(p: float) -> float:
    return math.log(p / (1.0 - p))


class OccupancyMap(NamedTuple):
    """A fleet of fixed-capacity log-odds occupancy maps (+ coarse match index)."""

    voxel_size: torch.Tensor  # (B,) f32
    keys: torch.Tensor  # (B, V, 3) i32
    used: torch.Tensor  # (B, V) bool — slot owned (free OR occupied knowledge)
    logodds: torch.Tensor  # (B, V) f32
    match: vh.VoxelHashMap  # occupied-voxel centers on the coarse grid
    l_hit: torch.Tensor  # (B,) f32 — the insert and likelihood parameters
    l_miss: torch.Tensor
    l_min: torch.Tensor
    l_max: torch.Tensor
    l_occ: torch.Tensor  # occupiedThreshold

    MATCH_GRID_FACTOR = 8  # coarse match-index cell = factor * resolution
    MATCH_POINTS_PER_VOXEL = 32

    @property
    def num_slots(self) -> int:
        return self.keys.shape[1]

    def occupied(self) -> torch.Tensor:
        return self.used & (self.logodds > self.l_occ[:, None])

    def num_voxels(self) -> torch.Tensor:
        return torch.sum(self.occupied(), dim=-1)

    def is_empty(self) -> torch.Tensor:
        return ~torch.any(self.occupied(), dim=-1)

    @staticmethod
    def create(
        num_slots: int, voxel_size, batch: int = 1, device="cuda", *, prob_hit: float = 0.7,
        prob_miss: float = 0.3, clamp_min: float = 0.05, clamp_max: float = 0.95,
        occupied_threshold: float = 0.6,
    ) -> "OccupancyMap":
        if num_slots & (num_slots - 1):
            raise ValueError("num_slots must be a power of two")

        def full(v):
            return torch.full((batch,), v, dtype=torch.float32, device=device)

        vs = full(float(voxel_size))
        match = vh.VoxelHashMap.create(
            num_slots, OccupancyMap.MATCH_POINTS_PER_VOXEL, 1.0, batch, device
        )._replace(voxel_size=vs * OccupancyMap.MATCH_GRID_FACTOR)
        return OccupancyMap(
            voxel_size=vs,
            keys=torch.zeros((batch, num_slots, 3), dtype=torch.int32, device=device),
            used=torch.zeros((batch, num_slots), dtype=torch.bool, device=device),
            logodds=torch.zeros((batch, num_slots), dtype=torch.float32, device=device),
            match=match,
            l_hit=full(_logit(prob_hit)),
            l_miss=full(_logit(prob_miss)),
            l_min=full(_logit(clamp_min)),
            l_max=full(_logit(clamp_max)),
            l_occ=full(_logit(occupied_threshold)),
        )

    def set_voxel_size(self, voxel_size: torch.Tensor) -> "OccupancyMap":
        """``voxel_size`` (B,); the match grid follows."""
        return self._replace(
            voxel_size=voxel_size,
            match=self.match._replace(voxel_size=voxel_size * self.MATCH_GRID_FACTOR),
        )

    def clear(self) -> "OccupancyMap":
        return self._replace(
            used=torch.zeros_like(self.used), logodds=torch.zeros_like(self.logodds), match=self.match.clear()
        )


def _scatter_set(table: torch.Tensor, idx: torch.Tensor, write: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """``table (B, V, ...)`` with ``vals`` written at the per-instance slots
    ``idx (B, n)`` where ``write`` (B, n) holds (JAX's ``.at[].set`` with
    ``mode="drop"`` for the rest).  Every writer of one slot writes the same
    value, so the result does not depend on the order of the writes.  The
    rest go to one sink row past the table."""
    B, V = table.shape[:2]
    flat = torch.cat([table.reshape((B * V,) + table.shape[2:]), table.new_zeros((1,) + table.shape[2:])])
    dest = torch.where(write, idx.long() + torch.arange(B, device=idx.device)[:, None] * V, B * V)
    flat.index_put_((dest.reshape(-1),), vals.reshape((-1,) + table.shape[2:]))
    return flat[: B * V].view(table.shape)


def _scatter_update(m: OccupancyMap, xyz: torch.Tensor, valid: torch.Tensor, delta: torch.Tensor) -> OccupancyMap:
    """Claim slots for the voxels of ``xyz`` (B, n, 3) and add ``delta`` (B,)
    log-odds to each point's slot (JAX ``occupancy._scatter_update``)."""
    B, n = valid.shape
    V = m.num_slots
    coords = voxel_coords(xyz, m.voxel_size.view(B, 1, 1))
    slot = voxel_hash(coords, V)
    same_key = torch.all(gather_rows(m.keys, slot).to(torch.float32) == coords.to(torch.float32), dim=-1)
    occupied = gather_rows(m.used, slot)
    accept, claim_ok = vh.claim_slots(same_key, occupied, coords, slot, valid, V)
    lo = torch.where(m.used, m.logodds, 0.0).reshape(-1)  # fresh claims start from log-odds 0
    flat = slot.long() + torch.arange(B, device=slot.device)[:, None] * V
    lo.index_add_(0, flat.reshape(-1), torch.where(accept, delta[:, None], 0.0).reshape(-1))
    lo = torch.clamp(lo.view(B, V), min=m.l_min[:, None], max=m.l_max[:, None])
    used = _scatter_set(m.used, slot, accept, torch.ones_like(accept))
    keys = _scatter_set(m.keys, slot, claim_ok, coords)
    return m._replace(keys=keys, used=used, logodds=lo)


def _first_argmin3(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Minimum over the last axis of length 3 and its FIRST index (the tie
    rule of ``jnp.argmin``)."""
    tmin = torch.amin(t, dim=-1)
    ax = torch.where(t[..., 0] == tmin, 0, torch.where(t[..., 1] == tmin, 1, 2))
    return tmin, ax


def _dda_voxels(origin: torch.Tensor, xyz: torch.Tensor, valid: torch.Tensor, voxel_size: torch.Tensor,
                n_steps: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact Amanatides-Woo walk from ``origin`` (B, 3) toward each point of
    ``xyz`` (B, N, 3): ``(coords (B, S, N, 3) i32, emit (B, S, N))``, the first
    ``S = n_steps`` voxels each beam crosses (the origin's first, each once),
    ``emit`` masking those whose entry ray parameter is not below
    ``range - voxel/2``.  The JAX ``lax.scan`` recurrence step by step:
    ``tmax`` advances by repeated ``+ onehot * tdelta``, ties go to the
    first axis."""
    B, N, _ = xyz.shape
    vs = voxel_size.view(B, 1, 1)
    d = xyz - origin[:, None, :]
    rng = torch.sqrt(se3.dot3(d, d))  # XLA fuses the squared norm as it fuses a dot
    lim = rng - 0.5 * vs[..., 0]
    safe = torch.clamp(torch.abs(d), min=1e-12)
    stepdir = torch.where(d >= 0, 1, -1).to(torch.int32)
    tdelta = vs * rng[..., None] / safe
    v0 = torch.floor(origin[:, None, :] / vs).to(torch.int32)
    frac = origin[:, None, :] / vs - v0.to(torch.float32)
    dist_to_edge = torch.where(d >= 0, 1.0 - frac, frac)
    tmax = torch.where(torch.abs(d) < 1e-12, torch.inf, dist_to_edge * tdelta)  # degenerate axes never advance
    v = v0.expand(B, N, 3)
    t_entry = torch.zeros_like(rng)
    coords = torch.empty((B, n_steps, N, 3), dtype=torch.int32, device=xyz.device)
    emit = torch.empty((B, n_steps, N), dtype=torch.bool, device=xyz.device)
    axes = torch.arange(3, device=xyz.device)
    for s in range(n_steps):
        coords[:, s] = v
        emit[:, s] = valid & (t_entry < lim)
        t_entry, ax = _first_argmin3(tmax)
        onehot = (ax[..., None] == axes).to(torch.int32)
        v = v + onehot * stepdir
        tmax = tmax + onehot.to(torch.float32) * tdelta
    return coords, emit


def insert(
    m: OccupancyMap, pc: PointCloud, sensor_origin=None, *, ray_trace: bool = True, max_ray_samples: int = 512
) -> OccupancyMap:
    """Insert a scan (map frame); :func:`insert_stats` without its counters."""
    return insert_stats(m, pc, sensor_origin, ray_trace=ray_trace, max_ray_samples=max_ray_samples)[0]


def insert_stats(
    m: OccupancyMap, pc: PointCloud, sensor_origin=None, *, ray_trace: bool = True, max_ray_samples: int = 512
) -> Tuple[OccupancyMap, vh.InsertStats]:
    """Insert a scan (map frame): the misses pass along each beam from
    ``sensor_origin`` (B, 3), the hits pass, then the match index rebuilt
    from the live occupied set.  Returns the match insert's counters."""
    B = pc.valid.shape[0]
    if ray_trace:
        origin = torch.zeros((B, 3), device=pc.xyz.device) if sensor_origin is None else sensor_origin
        coords, emit = _dda_voxels(origin, pc.xyz, pc.valid, m.voxel_size, max_ray_samples)
        centers = (coords.to(torch.float32) + 0.5) * m.voxel_size.view(B, 1, 1, 1)
        m = _scatter_update(m, centers.view(B, -1, 3), emit.view(B, -1), m.l_miss)
    return rebuild_match(_scatter_update(m, pc.xyz, pc.valid, m.l_hit))


def rebuild_match(m: OccupancyMap) -> Tuple[OccupancyMap, vh.InsertStats]:
    """Rebuild the match index from the live occupied set: an epoch-bump
    clear, one slab of state lanes hard-zeroed (the 16-bit epoch wraps),
    one insert of every occupied voxel center."""
    B = m.keys.shape[0]
    all_centers = (m.keys.to(torch.float32) + 0.5) * m.voxel_size.view(B, 1, 1)
    mc = m.match.clear()
    mc = vh.zero_state_slab(mc, mc.epoch, n_slabs=64)
    match, mstats = vh.insert_stats(mc, PointCloud.from_xyz(all_centers, valid=m.occupied()))
    return m._replace(match=match), mstats


def prune_farther_than(m: OccupancyMap, center: torch.Tensor, distance) -> OccupancyMap:
    """Drop every voxel whose center lies farther than ``distance`` (the
    L-inf norm of the offset, as the JAX package) from ``center`` (B, 3);
    ``distance <= 0`` disables."""
    B = center.shape[0]
    centers = (m.keys.to(torch.float32) + 0.5) * m.voxel_size.view(B, 1, 1)
    linf = torch.amax(torch.abs(centers - center[:, None, :]), dim=-1)
    dist = on_device(distance, torch.float32, center.device).expand(B)[:, None]
    keep = (linf <= dist) | (dist <= 0)
    return m._replace(used=m.used & keep, match=vh.prune_farther_than(m.match, center, distance))


def capture(m: OccupancyMap, queries: torch.Tensor, neighbors: int = 27) -> vh.CandSet:
    """Neighbourhood candidates from the coarse match index (occupied-voxel
    centers): every matcher path of the point maps applies to them."""
    return vh.capture(m.match, queries, neighbors)


def query_p2p(m: OccupancyMap, queries, valid, *, neighbors: int = 27):
    """Nearest occupied voxel center per query: ``(tgt, d2, found)``."""
    return vh.nn_from(capture(m, queries, neighbors), queries, valid)


def query_p2p2(m: OccupancyMap, queries, valid, *, neighbors: int = 27):
    """Two nearest occupied voxel centers (``pairingsPerPoint: 2``)."""
    return vh.nn2_from(capture(m, queries, neighbors), queries, valid)


def as_pointcloud(m: OccupancyMap, capacity: int) -> PointCloud:
    """The occupied voxel centers, valid first in slot order."""
    B = m.keys.shape[0]
    centers = (m.keys.to(torch.float32) + 0.5) * m.voxel_size.view(B, 1, 1)
    return PointCloud.from_xyz(centers, valid=m.occupied()).compact(capacity)
