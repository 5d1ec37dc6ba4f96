"""Device-resident sliding hash-voxel point map, batched over the fleet.

Port of ``mola_lidar_odometry_tpu/ops/voxel_hash.py`` (the insert with
its ``min_distance_between_points`` dedup and budget, the rolling-slab and
whole-table prunes, the occupancy map's slot claim, the neighbourhood
capture, the nearest-candidate selects ``nn_from``/``nn2_from``, the plane
fit ``p2pl_from`` over a captured set and the single-shot ``query_*``).
The table keeps the JAX layout word for word, so the two packages' tables
compare directly:

  * ``data (B, rows, 128) int32``: for strides up to 128 each 128-lane row
    is one W-way bucket of ``W = 128 // stride`` slot windows; a 256-lane
    window (K from 127 to 254) spans two rows and is a bucket of one way;
  * slot window ``[pkey | state | packed_pt * K | unused]``: ``pkey`` is the
    voxel key wrapped 12|12|8 bits (x|y|z), ``state`` is
    ``(epoch & 0xffff) << 16 | count``, and each point is one word holding
    its within-voxel offset quantized 10|10|10 bits (a full window has no
    unused lane);
  * a slot is live only while its epoch field equals the map's ``epoch``,
    so ``clear()`` is an epoch bump.

Insertion is the JAX package's sort-fused algorithm: one stable 2-key sort
``(bucket, signed pkey)`` groups each voxel's points, segmented scans in the
sorted domain give way claims and per-voxel ranks, and one flat scatter of
3 words per stored point updates the table.  JAX drops out-of-range scatter
indices; ``index_put_`` cannot, so each dropped entry repeats an entry that
is written anyway (:func:`_scatter_set`), which leaves the table as JAX's
drop does without a lane to spare.  The insert and the prune update
``data`` IN PLACE (the map returned holds the same tensor), which saves a
whole-table copy per step; callers must not keep the pre-insert table.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from mola_lidar_odometry_tpu_torch.ops import linalg
from mola_lidar_odometry_tpu_torch.ops.filters import _wrap_i32, voxel_coords, voxel_hash
from mola_lidar_odometry_tpu_torch.ops.pointcloud import PointCloud, gather_rows, on_device

_OFFS27 = [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)]
_CORNERS8 = [(i, j, k) for i in (0, 1) for j in (0, 1) for k in (0, 1)]
_FACES4 = [(0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1)]

# packed-key bit layout: x 12 | y 12 | z 8 (wrapped / modular)
_PKX_BITS, _PKY_BITS, _PKZ_BITS = 12, 12, 8
_PKX, _PKY, _PKZ = 1 << _PKX_BITS, 1 << _PKY_BITS, 1 << _PKZ_BITS

# within-voxel point quantization: 10 bits per axis (1024 offset cells)
_QBITS = 10
_Q = 1 << _QBITS
_INV_Q = 1.0 / _Q


def pack_key(coords: torch.Tensor) -> torch.Tensor:
    """Wrap (..., 3) i32 voxel coords into one i32 ``pkey`` (bit 31 is set
    for x >= 2048, so pkeys order as SIGNED int32)."""
    c = coords.to(torch.int64)
    k = (
        ((c[..., 0] & (_PKX - 1)) << (_PKY_BITS + _PKZ_BITS))
        | ((c[..., 1] & (_PKY - 1)) << _PKZ_BITS)
        | (c[..., 2] & (_PKZ - 1))
    )
    return _wrap_i32(k).to(torch.int32)


def unpack_key_near(pkey: torch.Tensor, anchor: torch.Tensor) -> torch.Tensor:
    """Decode wrapped keys to the representative nearest ``anchor``
    (broadcastable (..., 3) i32)."""
    ux = (pkey >> (_PKY_BITS + _PKZ_BITS)) & (_PKX - 1)
    uy = (pkey >> _PKZ_BITS) & (_PKY - 1)
    uz = pkey & (_PKZ - 1)

    def near(u, a, m):
        return a + (((u - a + m // 2) & (m - 1)) - m // 2)

    return torch.stack(
        [near(ux, anchor[..., 0], _PKX), near(uy, anchor[..., 1], _PKY), near(uz, anchor[..., 2], _PKZ)],
        dim=-1,
    )


def pack_points(xyz: torch.Tensor, coords: torch.Tensor, voxel_size) -> torch.Tensor:
    """(..., 3) f32 points + their (..., 3) i32 voxel coords -> (...,) i32
    within-voxel offsets quantized 10|10|10 bits (x|y|z)."""
    f = xyz / voxel_size - coords.to(torch.float32)
    q = torch.clamp((f * _Q).to(torch.int32), 0, _Q - 1)
    return (q[..., 0] << (2 * _QBITS)) | (q[..., 1] << _QBITS) | q[..., 2]


def unpack_points(word: torch.Tensor, coords: torch.Tensor, voxel_size) -> torch.Tensor:
    """Inverse of :func:`pack_points` at offset-cell centers; ``coords`` are
    the unwrapped voxel coords, broadcastable against ``word.shape + (3,)``."""
    q = torch.stack(
        [(word >> (2 * _QBITS)) & (_Q - 1), (word >> _QBITS) & (_Q - 1), word & (_Q - 1)], dim=-1
    ).to(torch.float32)
    return (coords.to(torch.float32) + (q + 0.5) * _INV_Q) * voxel_size


def _pick_stride(K: int) -> int:
    need = 2 + K
    for s in (32, 64, 128, 256):
        if need <= s:
            return s
    raise ValueError(f"points_per_voxel={K} too large (max 254)")


def neighbor_coords(queries: torch.Tensor, base: torch.Tensor, voxel_size, neighbors: int) -> torch.Tensor:
    """Voxel coords of the probe set per query: (..., N, 3) -> (..., N, P, 3) i32."""
    dev = base.device
    if neighbors == 27:
        return base[..., None, :] + on_device(_OFFS27, torch.int32, dev)
    if neighbors == 1:
        return base[..., None, :]
    if neighbors not in (4, 8):
        raise ValueError(f"neighbors must be 1, 4, 8 or 27, got {neighbors}")
    # the probe block on the side of the voxel center the query falls
    frac = queries / voxel_size - (base.to(torch.float32) + 0.5)
    step = torch.where(frac >= 0, 1, -1).to(torch.int32)
    offs = on_device(_CORNERS8 if neighbors == 8 else _FACES4, torch.int32, dev)
    return base[..., None, :] + offs * step[..., None, :]


class VoxelHashMap(NamedTuple):
    """A fleet of fixed-capacity voxel point maps (128-lane i32 slot windows)."""

    voxel_size: torch.Tensor  # (B,) f32
    data: torch.Tensor  # (B, rows, 128) i32
    epoch: torch.Tensor  # (B,) i32 — slots live iff their state epoch matches
    K: int = 20  # point capacity per voxel
    stride: int = 32  # lanes per slot window

    @property
    def num_slots(self) -> int:
        return self.data.shape[-2] * 128 // self.stride

    @property
    def ways(self) -> int:
        return max(128 // self.stride, 1)

    @property
    def num_buckets(self) -> int:
        return self.num_slots // self.ways

    @property
    def points_per_voxel(self) -> int:
        return self.K

    @property
    def epoch16(self) -> torch.Tensor:
        return self.epoch & 0xFFFF

    def windows(self) -> torch.Tensor:
        """(B, V, stride) i32 — one window per logical slot."""
        return self.data.view(self.data.shape[0], self.num_slots, self.stride)

    def buckets(self) -> torch.Tensor:
        """(B, num_buckets, W * stride) i32 — all ways of each bucket: the
        128-lane rows for strides up to 128, row pairs for stride 256 (the
        JAX package's ``_gather_buckets`` reads the same words)."""
        return self.data.view(self.data.shape[0], self.num_buckets, self.ways * self.stride)

    def count(self) -> torch.Tensor:
        """(B, V) live point count per slot."""
        state = self.windows()[..., 1]
        fresh = ((state >> 16) & 0xFFFF) == self.epoch16[:, None]
        return torch.where(fresh, state & 0xFFFF, 0)

    def num_points(self) -> torch.Tensor:
        """(B,) live points."""
        return torch.sum(self.count(), dim=-1)

    def num_voxels(self) -> torch.Tensor:
        """(B,) live voxels."""
        return torch.sum(self.count() > 0, dim=-1)

    def is_empty(self) -> torch.Tensor:
        return torch.all(self.count() == 0, dim=-1)

    @staticmethod
    def create(num_slots: int, points_per_voxel: int, voxel_size, batch: int, device="cuda") -> "VoxelHashMap":
        if num_slots & (num_slots - 1):
            raise ValueError("num_slots must be a power of two")
        K = int(points_per_voxel)
        stride = _pick_stride(K)
        if num_slots * stride < 128:  # tiny test maps: widen the windows
            stride = 128 // num_slots
        rows = num_slots * stride // 128
        return VoxelHashMap(
            voxel_size=torch.full((batch,), float(voxel_size), dtype=torch.float32, device=device),
            data=torch.zeros((batch, rows, 128), dtype=torch.int32, device=device),
            epoch=torch.ones((batch,), dtype=torch.int32, device=device),  # zero rows are born dead
            K=K,
            stride=stride,
        )

    def clear(self) -> "VoxelHashMap":
        return self._replace(epoch=self.epoch + 1)


class InsertStats(NamedTuple):
    """Capacity-pressure counters of one insert batch, (B,) i32 each."""

    collision_drops: torch.Tensor
    full_drops: torch.Tensor
    deferred_drops: torch.Tensor

    @staticmethod
    def zero(batch: int, device="cuda") -> "InsertStats":
        z = torch.zeros((batch,), dtype=torch.int32, device=device)
        return InsertStats(z, z, z)

    def __add__(self, other: "InsertStats") -> "InsertStats":
        return InsertStats(*(a + b for a, b in zip(self, other)))


def _seg_cumsum(x: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    """Inclusive per-row scan that restarts at every ``head`` (the JAX
    package's ``associative_scan(seg_sum)``): a cumsum minus the cumsum
    just before the latest head."""
    n = x.shape[-1]
    cs = torch.cumsum(x.to(torch.int64), dim=-1)
    idx = torch.arange(n, device=x.device).expand_as(cs)
    h = torch.cummax(torch.where(head, idx, 0), dim=-1).values
    base = torch.gather(cs, -1, h) - torch.gather(x.to(torch.int64), -1, h)
    return (cs - base).to(torch.int32)


def _seg_cumsum_reverse(x: torch.Tensor, tail: torch.Tensor) -> torch.Tensor:
    return torch.flip(_seg_cumsum(torch.flip(x, [-1]), torch.flip(tail, [-1])), [-1])


def _scatter_set(data: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor) -> None:
    """``data[b].flat[idx[b, j]] = vals[b, j]`` in place for every entry
    with ``idx >= 0``; an entry with ``idx < 0`` is dropped, as JAX drops an
    out-of-range scatter index.  The written indices of an instance must be
    distinct.  ``index_put_`` drops nothing, so a dropped entry repeats the
    instance's first written entry, index and value (or, when it writes
    none, word 0 with its own value): every word then receives one value
    only, the same on every run, and no lane has to stay unused."""
    B = data.shape[0]
    flat = data.view(B, -1)
    live = idx >= 0
    first = torch.argmax(live.to(torch.int32), dim=-1, keepdim=True)  # 0 when none is live
    any_live = torch.any(live, dim=-1, keepdim=True)
    idx = torch.where(live, idx, torch.where(any_live, torch.gather(idx, 1, first), 0))
    vals = torch.where(live, vals, torch.where(any_live, torch.gather(vals, 1, first), flat[:, :1]))
    flat_idx = idx.to(torch.int64) + torch.arange(B, device=data.device).view(B, 1) * flat.shape[1]
    data.view(-1).index_put_((flat_idx.view(-1),), vals.reshape(-1))


def insert(m: VoxelHashMap, pc: PointCloud, min_distance: float = 0.0) -> VoxelHashMap:
    """Insert the valid points of ``pc`` (already in the map frame)."""
    return insert_stats(m, pc, min_distance)[0]


def insert_stats(
    m: VoxelHashMap, pc: PointCloud, min_distance: float = 0.0, budget: int = 0
) -> Tuple[VoxelHashMap, InsertStats]:
    """Insert the valid points of ``pc`` (map frame) + capacity counters.

    Same algorithm and results as the JAX ``voxel_hash.insert_stats``; with
    ``0 < budget < n`` only the first ``budget`` storable points in
    (fill depth, stream position) order are written, the rest counted in
    ``deferred_drops``.  With ``min_distance > 0``
    (``min_distance_between_points``) a point closer than that to a point
    already stored in its voxel is refused; points of one batch do not see
    each other, and a refusal is not counted as a collision drop."""
    K, W, NB, s = m.K, m.ways, m.num_buckets, m.stride
    B, n = pc.valid.shape
    dev = pc.xyz.device
    e16 = m.epoch16[:, None]  # (B, 1)

    vs = m.voxel_size.view(B, 1, 1)
    coords = voxel_coords(pc.xyz, vs)
    bucket = voxel_hash(coords, NB)
    pkey = pack_key(coords)
    sort_key = torch.where(pc.valid, bucket, NB)
    pos = torch.arange(n, dtype=torch.int32, device=dev).expand(B, n)
    packed_pre = pack_points(pc.xyz, coords, vs)

    # 2-key stable sort (bucket, pkey as SIGNED i32): one int64 key, pkey
    # biased by 2^31 so its unsigned order is the signed order
    comb = (sort_key.to(torch.int64) << 32) | (pkey.to(torch.int64) + (1 << 31))
    _, perm = torch.sort(comb, dim=-1, stable=True)
    sb = torch.gather(sort_key, -1, perm)
    spk = torch.gather(pkey, -1, perm)
    s_packed = torch.gather(packed_pre, -1, perm)
    s_valid = sb < NB
    s_bucket = torch.where(s_valid, sb, pos % NB)

    g_flat = gather_rows(m.buckets(), s_bucket)  # (B, n, W * s): all W ways per point
    g = g_flat.view(B, n, W, s)
    pk_w, st_w = g[..., 0], g[..., 1]
    fresh_w = ((st_w >> 16) & 0xFFFF) == e16[..., None]
    match_w = fresh_w & (pk_w == spk[..., None]) & s_valid[..., None]
    any_match = torch.any(match_w, dim=-1)
    widx = torch.arange(W, dtype=torch.int32, device=dev)
    exist_way = torch.amin(torch.where(match_w, widx, W), dim=-1)
    exist_way = torch.where(any_match, exist_way, 0)
    cnt_exist = torch.sum(torch.where(match_w, st_w & 0xFFFF, 0), dim=-1, dtype=torch.int32)

    ones = torch.ones((B, 1), dtype=torch.bool, device=dev)
    b_chg = sb[:, 1:] != sb[:, :-1]
    v_chg = b_chg | (spk[:, 1:] != spk[:, :-1])
    is_bucket_head = torch.cat([ones, b_chg], dim=-1)
    is_voxel_head = torch.cat([ones, v_chg], dim=-1)
    is_voxel_tail = torch.cat([v_chg, ones], dim=-1)

    # way claim: the r-th claiming voxel of a bucket takes its r-th stale way
    claim_head = (is_voxel_head & s_valid & ~any_match).to(torch.int32)
    r = _seg_cumsum(claim_head, is_bucket_head) - 1
    free_w = ~fresh_w
    free_i = free_w.to(torch.int32)
    free_before = torch.cumsum(free_i, dim=-1, dtype=torch.int32) - free_i
    free_cnt = torch.sum(free_i, dim=-1, dtype=torch.int32)
    claim_ok = s_valid & ~any_match & (r >= 0) & (r < free_cnt)
    claim_way = torch.sum(
        torch.where(free_w & (free_before == r[..., None]), widx, 0), dim=-1, dtype=torch.int32
    )
    accept = any_match | claim_ok
    way = torch.where(any_match, exist_way, claim_way)
    cnt_at = torch.where(any_match, cnt_exist, 0)

    too_close = None
    if min_distance > 0:
        # the stored points of my voxel, from the gathered bucket row,
        # dequantized against my own voxel coords (JAX :516-541)
        s_xyz = gather_rows(pc.xyz, perm)
        s_coords = voxel_coords(s_xyz, vs)
        kj = torch.arange(K, dtype=torch.int32, device=dev)
        cols = (way * s)[..., None] + 2 + kj
        spts = unpack_points(torch.gather(g_flat, -1, cols.long()), s_coords[:, :, None, :], vs[..., None])
        stored = kj < cnt_at[..., None]
        d2s = torch.sum((spts - s_xyz[:, :, None, :]) ** 2, dim=-1)
        too_close = torch.any(stored & (d2s < min_distance * min_distance), dim=-1)
        accept = accept & ~too_close

    a32 = accept.to(torch.int32)
    rank = _seg_cumsum(a32, is_voxel_head) - a32
    dest = cnt_at + rank
    store = accept & (dest < K)

    C = int(budget)
    compact = 0 < C < n
    if compact:
        # keep the first C storables in (fill depth, stream position) order
        shift = max(1, (n - 1).bit_length())
        if (K << shift) >= 1 << 30:
            raise ValueError(f"insert priority key overflows int32: K={K}, n={n}")
        sentinel = 1 << 30
        pkey_prio = torch.where(store, (dest << shift) | pos, sentinel)
        prio_sorted, _ = torch.sort(pkey_prio, dim=-1)
        prio_sel = prio_sorted[:, :C] & ((1 << shift) - 1)
        prio_live = prio_sorted[:, :C] < sentinel
        keep = store & (pkey_prio < prio_sorted[:, C : C + 1])
    else:
        keep = store

    k32 = keep.to(torch.int32)
    n_kept = _seg_cumsum(k32, is_voxel_head) + _seg_cumsum_reverse(k32, is_voxel_tail) - k32
    cnt_fin = torch.clamp(cnt_at + n_kept, max=K)
    state_fin = _wrap_i32((e16.to(torch.int64) << 16) | cnt_fin).to(torch.int32)
    head = keep & (rank == 0)  # pkey/state written once per (voxel, way)

    drop = -1  # the dropped-entry index (JAX's out-of-range one)
    p_base = (s_bucket * W + way) * s
    idx = torch.stack(
        [
            torch.where(keep, p_base + 2 + dest, drop),
            torch.where(head, p_base, drop),
            torch.where(head, p_base + 1, drop),
        ],
        dim=-1,
    )  # (B, n, 3)
    vals = torch.stack([s_packed, spk, state_fin], dim=-1)
    if compact:
        live = prio_live[..., None]
        idx = torch.where(live, gather_rows(idx, prio_sel), drop)
        vals = gather_rows(vals, prio_sel)
    _scatter_set(m.data, idx.reshape(B, -1), vals.reshape(B, -1))

    refused = s_valid & ~accept
    if too_close is not None:
        refused = refused & ~too_close  # dedup refusals are intended, not capacity pressure
    stats = InsertStats(
        collision_drops=torch.sum(refused, dim=-1, dtype=torch.int32),
        full_drops=torch.sum(accept & (dest >= K), dim=-1, dtype=torch.int32),
        deferred_drops=torch.sum(store & ~keep, dim=-1, dtype=torch.int32),
    )
    return m, stats


def _slab_rows(m: VoxelHashMap, slab: torch.Tensor, n_slabs: int):
    R = m.data.shape[1]
    S = R // n_slabs
    start = (slab.to(torch.int64) % n_slabs) * S  # (B,)
    return start[:, None] + torch.arange(S, device=m.data.device)  # (B, S)


def prune_farther_than_slab(
    m: VoxelHashMap, center: torch.Tensor, distance, slab: torch.Tensor, n_slabs: int = 64
) -> VoxelHashMap:
    """Rolling-slab eviction: zero the state lane of every live slot in row
    slab ``slab % n_slabs`` whose voxel center lies farther than ``distance``
    (L-inf of the offset, as the JAX package) from ``center`` (B, 3).
    ``distance <= 0`` disables.  Updates ``m.data`` in place."""
    B = m.data.shape[0]
    ridx = _slab_rows(m, slab, n_slabs)
    if ridx.shape[1] == 0:
        return m
    b = torch.arange(B, device=m.data.device)[:, None]
    rows = m.data[b, ridx]  # (B, S, 128)
    w = rows.view(B, -1, m.stride)
    pkey, state = w[..., 0], w[..., 1]
    live = ((state >> 16) & 0xFFFF) == m.epoch16[:, None]
    vs = m.voxel_size
    cvox = voxel_coords(center, vs[:, None])  # (B, 3)
    kvox = unpack_key_near(pkey, cvox[:, None, :])
    centers = (kvox.to(torch.float32) + 0.5) * vs[:, None, None]
    l1 = torch.amax(torch.abs(centers - center[:, None, :]), dim=-1)
    dist = on_device(distance, torch.float32, m.data.device).expand(B)[:, None]
    kill = live & (l1 > dist) & (dist > 0)
    lane1 = torch.arange(m.stride, device=m.data.device) == 1
    neww = torch.where(kill[..., None] & lane1, 0, w)
    m.data[b, ridx] = neww.view(B, -1, 128)
    return m


def prune_farther_than(m: VoxelHashMap, center: torch.Tensor, distance) -> VoxelHashMap:
    """The whole-table prune (``remove_voxels_farther_than``): the slab
    prune over one slab that is the whole table."""
    zero = torch.zeros((m.data.shape[0],), dtype=torch.int64, device=m.data.device)
    return prune_farther_than_slab(m, center, distance, zero, n_slabs=1)


def claim_slots(
    same_key: torch.Tensor, occupied: torch.Tensor, coords: torch.Tensor, slot: torch.Tensor,
    valid: torch.Tensor, num_slots: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Atomics-free parallel slot claim of a direct-mapped table (the
    occupancy map's), per instance: (B, n) flags of each point's slot
    (``same_key``: it holds my voxel; ``occupied``: it is owned), (B, n, 3)
    voxel coords, (B, n) slots.  An empty slot goes to the lowest-index
    valid point hashing to it (a ``scatter_reduce_`` "amin", the same on
    every run); a different voxel racing for it drops this frame.  Returns
    ``(accept, claim_ok)``: the point may write its slot; its voxel newly
    owns the slot (write the key)."""
    B, n = slot.shape
    dev = slot.device
    idx = torch.arange(n, dtype=torch.int32, device=dev).expand(B, n)
    wants_claim = valid & ~occupied
    claim = torch.full((B, num_slots), n, dtype=torch.int32, device=dev)
    claim.scatter_reduce_(1, slot.long(), torch.where(wants_claim, idx, n), "amin")
    winner = torch.gather(claim, 1, slot.long())
    claim_won = wants_claim & (winner < n)
    winner_coords = gather_rows(coords, torch.where(claim_won, winner, 0))
    claim_ok = claim_won & torch.all(winner_coords == coords, dim=-1)
    return valid & ((occupied & same_key) | claim_ok), claim_ok


def zero_state_slab(m: VoxelHashMap, slab: torch.Tensor, n_slabs: int = 64) -> VoxelHashMap:
    """Hard-zero the state lanes of one contiguous row slab (1/``n_slabs``
    of the table), cycling with ``slab`` — guards the 16-bit epoch wrap for
    callers that clear every frame.  Updates ``m.data`` in place."""
    B = m.data.shape[0]
    ridx = _slab_rows(m, slab, min(int(n_slabs), m.data.shape[1]))
    b = torch.arange(B, device=m.data.device)[:, None]
    lane = torch.arange(128, device=m.data.device)
    if m.stride <= 128:
        is_state = (lane % m.stride) == 1
    else:
        # a window spans stride/128 rows: its state is lane 1 of its FIRST
        # row only (lane 1 of the others holds a point word)
        is_state = (lane == 1) & ((ridx % (m.stride // 128)) == 0)[..., None]
    m.data[b, ridx] = torch.where(is_state, 0, m.data[b, ridx])
    return m


class CandSet(NamedTuple):
    """Cached neighborhood candidates of a query batch."""

    pts: torch.Tensor  # (B, N, C, 3)
    mask: torch.Tensor  # (B, N, C)


# Candidate entries (instances x queries x candidates) per pass of a capture
# or plane fit: wider inputs (27 probes of a K = 64 map over tens of
# thousands of queries, rgbd at the bench's width) run in chunks of
# queries, so their temporaries stay near 2 GB.  Every output row depends
# on its own query only, so the results are those of one pass.
_CHUNK_ENTRIES = 1 << 27


def _by_query_chunks(fn, queries: torch.Tensor, per_query: int, *rest):
    """``fn(queries, *rest)`` over chunks of the query axis (dim 1 of
    ``queries`` and of every tensor in ``rest``, which may hold tuples of
    them), the outputs (tuples of (B, N, ...) tensors) concatenated; one
    call when the input is narrow enough."""
    B, n = queries.shape[:2]
    step = max(1, _CHUNK_ENTRIES // max(1, B * per_query))
    if n <= step:
        return fn(queries, *rest)

    def like(t, items):
        return type(t)(*items) if hasattr(t, "_fields") else tuple(items)

    def cut(x, a, b):
        return x[:, a:b] if torch.is_tensor(x) else like(x, [cut(v, a, b) for v in x])

    parts = [fn(queries[:, a : a + step], *(cut(r, a, a + step) for r in rest)) for a in range(0, n, step)]
    return like(parts[0], [torch.cat(xs, dim=1) for xs in zip(*parts)])


def capture(m: VoxelHashMap, queries: torch.Tensor, neighbors: int = 27, per_voxel_nn: bool = False) -> CandSet:
    """Gather the packed neighborhood windows around ``queries`` (B, N, 3).

    With ``per_voxel_nn`` each probed voxel's K points reduce to the two
    nearest the query (first-min tie-break), leaving 2P candidates."""
    P = neighbors
    return _by_query_chunks(lambda q: _capture(m, q, neighbors, per_voxel_nn), queries, P * m.K)


def _capture(m: VoxelHashMap, queries: torch.Tensor, neighbors: int, per_voxel_nn: bool) -> CandSet:
    B, n, _ = queries.shape
    K, W, s = m.K, m.ways, m.stride
    vs = m.voxel_size.view(B, 1, 1)
    base = voxel_coords(queries, vs)
    cand = neighbor_coords(queries, base, vs, neighbors)  # (B, N, P, 3)
    P = cand.shape[2]
    buckets = voxel_hash(cand, m.num_buckets)
    gb = gather_rows(m.buckets(), buckets.view(B, n * P)).view(B, n, P, W, s)
    target = pack_key(cand)
    e16 = m.epoch16.view(B, 1, 1, 1)
    ok_w = (gb[..., 0] == target[..., None]) & (((gb[..., 1] >> 16) & 0xFFFF) == e16)
    g = gb[..., 0, :]
    for w in range(1, W):
        g = torch.where(ok_w[..., w, None], gb[..., w, :], g)
    match = torch.any(ok_w, dim=-1)
    cnt = torch.where(match, g[..., 1] & 0xFFFF, 0)
    live = match & (cnt > 0)
    pts4 = unpack_points(g[..., 2 : 2 + K], cand[..., None, :], m.voxel_size.view(B, 1, 1, 1, 1))
    jslots = torch.arange(K, device=queries.device)
    cmask4 = live[..., None] & (jslots < cnt[..., None])  # (B, N, P, K)
    if not (per_voxel_nn and K > 2):
        return CandSet(pts4.reshape(B, n, P * K, 3), cmask4.reshape(B, n, P * K))
    big = 3.4e38
    d2 = torch.sum((pts4 - queries[:, :, None, None, :]) ** 2, dim=-1)
    d2 = torch.where(cmask4, d2, big)

    def pick(d2m):
        dmin = torch.amin(d2m, dim=-1, keepdim=True)
        first = torch.amin(torch.where(d2m <= dmin, jslots, K), dim=-1, keepdim=True)
        oh = jslots == first
        return torch.sum(pts4 * oh[..., None], dim=-2), torch.any(d2m < big, dim=-1), oh

    p1, m1, oh1 = pick(d2)
    p2, m2, _ = pick(torch.where(oh1, big, d2))
    return CandSet(torch.cat([p1, p2], dim=2), torch.cat([m1, m2], dim=2))


def _masked_d2(cand: CandSet, queries: torch.Tensor) -> torch.Tensor:
    d2 = torch.sum((cand.pts - queries[:, :, None, :]) ** 2, dim=-1)
    return torch.where(cand.mask, d2, torch.inf)


def _first_min(d2: torch.Tensor, exclude: torch.Tensor = None):
    """Row minimum and the lowest index attaining it (``argmin``'s choice in
    the JAX package; ``torch.argmin`` does not promise it), skipping the
    ``exclude`` index (B, N, 1) when given."""
    C = d2.shape[-1]
    lane = torch.arange(C, device=d2.device)
    if exclude is not None:
        d2 = torch.where(lane == exclude, torch.inf, d2)
    dmin = torch.amin(d2, dim=-1, keepdim=True)
    hit = d2 <= dmin
    if exclude is not None:
        hit = hit & (lane != exclude)
    return dmin, torch.amin(torch.where(hit, lane, C), dim=-1, keepdim=True)


def nn_from(cand: CandSet, queries: torch.Tensor, valid: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Nearest candidate per query: ``(tgt (B, N, 3), d2 (B, N), found)``."""
    dmin, j = _first_min(_masked_d2(cand, queries))
    pmin = torch.gather(cand.pts, 2, j[..., None].expand(-1, -1, -1, 3))[:, :, 0]
    dmin = dmin[..., 0]
    found = valid & torch.isfinite(dmin)
    return pmin, torch.where(found, dmin, torch.inf), found


def nn2_from(cand: CandSet, queries: torch.Tensor, valid: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Two nearest candidates per query (``pairingsPerPoint: 2``):
    ``(tgt (B, N, 2, 3), d2 (B, N, 2), found (B, N, 2))``, nearest first,
    equal distances in index order (the JAX package's ``top_k``)."""
    d2 = _masked_d2(cand, queries)
    d1, j1 = _first_min(d2)
    d2nd, j2 = _first_min(d2, exclude=j1)
    ti = torch.cat([j1, j2], dim=-1)  # (B, N, 2)
    best_pt = torch.gather(cand.pts, 2, ti[..., None].expand(-1, -1, -1, 3))
    best_d2 = torch.cat([d1, d2nd], dim=-1)
    found = valid[..., None] & torch.isfinite(best_d2)
    return best_pt, torch.where(found, best_d2, torch.inf), found


def p2pl_from(
    cand: CandSet,
    queries: torch.Tensor,
    valid: torch.Tensor,
    *,
    search_radius: float = 0.8,
    min_plane_points: int = 6,
    plane_eigen_threshold: float = 1e-2,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Point-to-plane against cached candidates: fit a plane per query to
    every candidate within ``search_radius`` (``Matcher_Point2Plane``
    against a point map).  Moments are accumulated query-relative; returns
    ``(plane_pt, normal, dist2, found)``."""
    kw = dict(search_radius=search_radius, min_plane_points=min_plane_points,
              plane_eigen_threshold=plane_eigen_threshold)
    return _by_query_chunks(lambda q, c, v: _p2pl(c, q, v, **kw), queries, cand.mask.shape[-1], cand, valid)


def _p2pl(cand: CandSet, queries: torch.Tensor, valid: torch.Tensor, *, search_radius: float,
          min_plane_points: int, plane_eigen_threshold: float):
    rel = cand.pts - queries[:, :, None, :]  # (B, N, C, 3)
    d2 = torch.sum(rel * rel, dim=-1)
    w = (cand.mask & (d2 <= search_radius * search_radius)).to(torch.float32)
    cnt = torch.sum(w, dim=-1)
    # the weighted first and second moments as batched products over the
    # candidates (the JAX package's einsums); w is 0 or 1, so w * rel is exact
    wrel = rel * w[..., None]
    s = torch.einsum("bnc,bncd->bnd", w, rel)
    m2 = torch.einsum("bnci,bncj->bnij", wrel, rel)  # (B, N, 3, 3)
    ss = torch.stack([m2[..., 0, 0], m2[..., 1, 1], m2[..., 2, 2], m2[..., 0, 1], m2[..., 0, 2], m2[..., 1, 2]], -1)
    nf = torch.clamp(cnt, min=1.0)[..., None]
    mean_rel = s / nf  # plane centroid relative to the query
    mx, my, mz = mean_rel.unbind(-1)
    cov6 = ss / nf - torch.stack([mx * mx, my * my, mz * mz, mx * my, mx * mz, my * mz], dim=-1)
    nrm, e_min, e_mid = linalg.sym_eigen_smallest(cov6)
    plane_ok = (cnt >= min_plane_points) & (e_min <= plane_eigen_threshold * torch.clamp(e_mid, min=1e-12))
    found = valid & plane_ok
    dpl = -torch.sum(nrm * mean_rel, dim=-1)  # signed distance: query - centroid
    plane_pt = queries - dpl[..., None] * nrm
    return plane_pt, nrm, torch.where(found, dpl * dpl, torch.inf), found


def query_nn(m: VoxelHashMap, queries: torch.Tensor, valid: torch.Tensor, *, neighbors: int = 27):
    """Single-shot nearest-neighbour query (capture + select):
    ``(nn_xyz (B, N, 3), dist2 (B, N), found (B, N))``."""
    return nn_from(capture(m, queries, neighbors), queries, valid)


def query_nn2(m: VoxelHashMap, queries: torch.Tensor, valid: torch.Tensor, *, neighbors: int = 27):
    """Single-shot two-nearest query (``pairingsPerPoint: 2``)."""
    return nn2_from(capture(m, queries, neighbors), queries, valid)


def query_p2pl(
    m: VoxelHashMap,
    queries: torch.Tensor,
    valid: torch.Tensor,
    *,
    search_radius: float = 0.8,
    min_plane_points: int = 6,
    plane_eigen_threshold: float = 1e-2,
    neighbors: int = 27,
):
    """Single-shot point-to-plane query against a point map."""
    return p2pl_from(capture(m, queries, neighbors), queries, valid, search_radius=search_radius,
                     min_plane_points=min_plane_points, plane_eigen_threshold=plane_eigen_threshold)


def derive_anchor_vox(m: VoxelHashMap) -> torch.Tensor:
    """(B, 3) i32 unwrap anchors derived from the map's own live keys
    (``voxel_hash.derive_anchor_vox`` of the JAX package): per axis the
    live wrapped key values are angles on a circle of period ``2^bits``,
    and their circular mean, rounded and made signed, is the anchor.  Every
    live voxel of a map within half the wrap range unwraps exactly relative
    to it; the absolute offset is exact modulo the wrap period."""
    win = m.windows()
    pkey = win[..., 0]
    wt = (m.count() > 0).to(torch.float32)  # (B, V)
    nf = torch.clamp(torch.sum(wt, dim=-1), min=1.0)

    def axis_mean(u, period):
        theta = u.to(torch.float32) * (2.0 * math.pi / period)
        c = torch.sum(torch.cos(theta) * wt, dim=-1) / nf
        s = torch.sum(torch.sin(theta) * wt, dim=-1) / nf
        a = torch.round(torch.atan2(s, c) * (period / (2.0 * math.pi))).to(torch.int32)
        return ((a + period // 2) & (period - 1)) - period // 2

    ux = (pkey >> (_PKY_BITS + _PKZ_BITS)) & (_PKX - 1)
    uy = (pkey >> _PKZ_BITS) & (_PKY - 1)
    uz = pkey & (_PKZ - 1)
    return torch.stack([axis_mean(ux, _PKX), axis_mean(uy, _PKY), axis_mean(uz, _PKZ)], dim=-1)


def as_pointcloud(m: VoxelHashMap, capacity: int, anchor: Optional[torch.Tensor] = None) -> PointCloud:
    """Flatten the live voxel contents into a ``(B, capacity)`` PointCloud
    (viz, map publishing, export), valid points first in slot order.

    ``anchor`` (B, 3) f32 world positions (the current robot pose) anchor
    the unwrap of the wrapped voxel keys: positions are exact for voxels
    within half the wrap range of the anchor (+-1024 cells in x/y, +-128 in
    z), which the sliding local map under its eviction radius always is.
    Without one the anchor is derived from the live keys
    (:func:`derive_anchor_vox`), as for a map read back from a file."""
    B, V, K = m.data.shape[0], m.num_slots, m.K
    vs = m.voxel_size.view(B, 1, 1)
    if anchor is None:
        avox = derive_anchor_vox(m)[:, None, :]
    else:
        avox = voxel_coords(anchor.to(torch.float32)[:, None, :], vs)  # (B, 1, 3)
    win = m.windows()
    coords = unpack_key_near(win[..., 0], avox)  # (B, V, 3)
    pts = unpack_points(win[..., 2 : 2 + K], coords[:, :, None, :], vs[..., None])  # (B, V, K, 3)
    live = torch.arange(K, device=m.data.device) < m.count()[..., None]  # (B, V, K)
    pc = PointCloud.from_xyz(pts.reshape(B, V * K, 3), valid=live.reshape(B, V * K))
    return pc.compact(capacity)
