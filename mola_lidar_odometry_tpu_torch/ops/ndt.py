"""NDT voxel map (per-voxel Gaussians and plane normals), batched over the fleet.

Port of ``mola_lidar_odometry_tpu/ops/ndt.py``: the map of the lidar3d-ndt
pipeline (reference ``mola::NDT``) and the plane side of
``Matcher_Point2Plane``.  The table keeps the JAX layout word for word, so
the two packages' tables compare directly:

  * ``data (B, num_slots / 4, 128) int32``: each row is a 4-way bucket of
    32-lane slot windows;
  * lane 0 the wrapped 12|12|8 voxel key, lane 1 ``epoch16 << 16 | n``;
  * lanes 2:5 and 5:11 the first and second moment sums, relative to the
    voxel center, lanes 11:14 the mean (map frame), 14:17 the plane normal,
    all float32 bits; lane 17 the plane flag;
  * lanes 18:32 the claim bitmask of the ``min_distance_between_points``
    sub-cells.

The insert is the JAX package's sort-fused algorithm: one sort groups each
voxel's points, segmented scans give way claims and each voxel's
post-insert totals, and one scatter writes 18 (32 with the sub-cell dedup)
words per voxel, from its last writing point (the one XLA's in-order
scatter leaves).  A voxel's float32 moments are summed
in the order of JAX's ``associative_scan``, so they round as there: the
plane gate ``lambda_min >= -1e-6`` of a flat voxel of a few points is
decided by the last bits of its moments.
Dropped scatter entries go to lane 31 of each instance's first slot
window, which no insert writes anything but zero to (the dedup bits end at
lane 28).  The insert and the prune update ``data`` in place.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from mola_lidar_odometry_tpu_torch.ops import linalg, se3
from mola_lidar_odometry_tpu_torch.ops.filters import _wrap_i32, voxel_coords, voxel_hash
from mola_lidar_odometry_tpu_torch.ops.pointcloud import PointCloud, gather_rows, on_device
from mola_lidar_odometry_tpu_torch.ops.voxel_hash import (
    InsertStats,
    _seg_cumsum,
    _seg_cumsum_reverse,
    neighbor_coords,
    pack_key,
    unpack_key_near,
)

_STRIDE = 32
_WAYS = 128 // _STRIDE  # 4
_MAX_N = 0xFFFF
# sub-cell dedup grid: G^3 <= 343 claim bits in lanes 18..28
_DEDUP_LANE0 = 18
_DEDUP_LANES = _STRIDE - _DEDUP_LANE0  # 14
_DEDUP_MAX_G = 7
_SINK = _STRIDE - 1  # the dropped-entry lane of slot window 0


class NdtMap(NamedTuple):
    """A fleet of fixed-capacity NDT voxel maps (4-way 128-lane bucket rows)."""

    voxel_size: torch.Tensor  # (B,) f32
    max_eigen_ratio: torch.Tensor  # (B,) f32 — lambda_min/lambda_mid plane gate
    data: torch.Tensor  # (B, num_slots/4, 128) i32
    epoch: torch.Tensor  # (B,) i32 — slots live iff their state epoch matches

    MIN_POINTS_FOR_PLANE = 5

    @property
    def num_slots(self) -> int:
        return self.data.shape[-2] * _WAYS

    @property
    def num_buckets(self) -> int:
        return self.data.shape[-2]

    @property
    def epoch16(self) -> torch.Tensor:
        return self.epoch & 0xFFFF

    # -- decoded whole-table views (B, V, ...) ------------------------------
    def windows(self) -> torch.Tensor:
        return self.data.view(self.data.shape[0], self.num_slots, _STRIDE)

    def fresh(self) -> torch.Tensor:
        return ((self.windows()[..., 1] >> 16) & 0xFFFF) == self.epoch16[:, None]

    def n(self) -> torch.Tensor:
        return torch.where(self.fresh(), self.windows()[..., 1] & 0xFFFF, 0)

    def means(self) -> torch.Tensor:
        w = self.windows()[..., 11:14].contiguous().view(torch.float32)
        return torch.where(self.fresh()[..., None], w, 0.0)

    def plane_ok(self) -> torch.Tensor:
        return self.fresh() & (self.windows()[..., 17] > 0)

    def num_voxels(self) -> torch.Tensor:
        return torch.sum(self.n() > 0, dim=-1)

    def is_empty(self) -> torch.Tensor:
        return torch.all(self.n() == 0, dim=-1)

    @staticmethod
    def create(num_slots: int, voxel_size, max_eigen_ratio=0.05, batch: int = 1, device="cuda") -> "NdtMap":
        if num_slots & (num_slots - 1) or num_slots < _WAYS:
            raise ValueError("num_slots must be a power of two >= 4")
        vs, ratio = (torch.full((batch,), float(v), dtype=torch.float32, device=device)
                     for v in (voxel_size, max_eigen_ratio))
        return NdtMap(
            voxel_size=vs,
            max_eigen_ratio=ratio,
            data=torch.zeros((batch, num_slots // _WAYS, 128), dtype=torch.int32, device=device),
            epoch=torch.ones((batch,), dtype=torch.int32, device=device),  # zero rows are born dead
        )

    def clear(self) -> "NdtMap":
        return self._replace(epoch=self.epoch + 1)


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    out = even.new_empty((even.shape[0], even.shape[1] + odd.shape[1]) + even.shape[2:])
    out[:, 0::2] = even
    out[:, 1::2] = odd
    return out


def _seg_scan(v: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    """Inclusive segmented sum along dim 1 of (B, n, k) ``v`` (segments
    start at ``head`` (B, n, 1)), adding in the order of the JAX package's
    ``jax.lax.associative_scan(seg_sum)`` (pairs, recursion on the half,
    then the even elements), so float32 sums round as they do there."""

    def comb(a, b):
        (va, fa), (vb, fb) = a, b
        return torch.where(fb, vb, va + vb), fa | fb

    def scan(v, f):
        n = v.shape[1]
        if n < 2:
            return v, f
        ov, of = scan(*comb((v[:, 0 : n - 1 : 2], f[:, 0 : n - 1 : 2]), (v[:, 1::2], f[:, 1::2])))
        if n % 2 == 0:
            ev, ef = comb((ov[:, :-1], of[:, :-1]), (v[:, 2::2], f[:, 2::2]))
        else:
            ev, ef = comb((ov, of), (v[:, 2::2], f[:, 2::2]))
        ev, ef = torch.cat([v[:, :1], ev], 1), torch.cat([f[:, :1], ef], 1)
        return _interleave(ev, ov), _interleave(ef, of)

    return scan(v, head)[0]


def _seg_total(x: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    """Per-element total of its segment (segments start at ``head`` (B, n)
    along dim 1 of (B, n, k) ``x``): the JAX package's ``incl + rincl -
    self`` of a forward and a reverse segmented scan."""
    h = head[..., None]
    tail = torch.cat([h[:, 1:], torch.ones_like(h[:, :1])], dim=1)
    incl = _seg_scan(x, h)
    rincl = torch.flip(_seg_scan(torch.flip(x, [1]), torch.flip(tail, [1])), [1])
    return incl + rincl - x


def _seg_or_total(x: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    """Per-element bitwise OR over its segment of (B, n, k) int32 ``x``: a
    segmented inclusive scan by doubling, read at each segment's tail."""
    B, n = head.shape
    v, f = x, head
    d = 1
    while d < n:
        v_sh = torch.cat([torch.zeros_like(v[:, :d]), v[:, :-d]], dim=1)
        f_sh = torch.cat([torch.ones_like(f[:, :d]), f[:, :-d]], dim=1)
        v = torch.where(f[..., None], v, v | v_sh)
        f = f | f_sh
        d *= 2
    idx = torch.arange(n, device=x.device).expand(B, n)
    tail = torch.cat([head[:, 1:], torch.ones_like(head[:, :1])], dim=1)
    t = torch.flip(torch.cummin(torch.flip(torch.where(tail, idx, n - 1), [1]), dim=1).values, [1])
    return torch.gather(v, 1, t[..., None].expand_as(v))


def insert(m: NdtMap, pc: PointCloud, min_distance: float = 0.0) -> NdtMap:
    """Accumulate the valid points of ``pc`` (map frame) into the Gaussians."""
    return insert_stats(m, pc, min_distance)[0]


def insert_stats(m: NdtMap, pc: PointCloud, min_distance: float = 0.0) -> Tuple[NdtMap, InsertStats]:
    """Sort-fused insert + capacity counters (the JAX ``ndt.insert_stats``).

    ``min_distance`` (``min_distance_between_points``): each slot window
    keeps a claim bitmask over ``G^3`` sub-cells of that size; a point in an
    already-claimed sub-cell is rejected and never enters the moments
    (points of one batch do not see each other)."""
    NB, W = m.num_buckets, _WAYS
    B, n = pc.valid.shape
    dev = pc.xyz.device
    e16 = m.epoch16[:, None]  # (B, 1)
    vs = m.voxel_size.view(B, 1, 1)

    coords = voxel_coords(pc.xyz, vs)
    bucket = voxel_hash(coords, NB)
    pkey = pack_key(coords)
    sort_key = torch.where(pc.valid, bucket, NB)
    # lexicographic (bucket, pkey as SIGNED i32, position): one stable sort
    comb = (sort_key.to(torch.int64) << 32) | (pkey.to(torch.int64) + (1 << 31))
    _, sidx = torch.sort(comb, dim=-1, stable=True)
    sb = torch.gather(sort_key, -1, sidx)
    spk = torch.gather(pkey, -1, sidx)
    s_valid = sb < NB
    s_bucket = torch.where(s_valid, sb, 0)

    g = gather_rows(m.data, s_bucket)  # (B, n, 128): the whole bucket
    gw = g.view(B, n, W, _STRIDE)
    pk_w, st_w = gw[..., 0], gw[..., 1]
    widx = torch.arange(W, dtype=torch.int32, device=dev)
    fresh_w = ((st_w >> 16) & 0xFFFF) == e16[..., None]
    match_w = fresh_w & (pk_w == spk[..., None]) & s_valid[..., None]
    any_match = torch.any(match_w, dim=-1)
    exist_way = torch.where(any_match, torch.amin(torch.where(match_w, widx, W), dim=-1), 0)
    n_exist = torch.sum(torch.where(match_w, st_w & 0xFFFF, 0), dim=-1, dtype=torch.int32)

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
    claim_way = torch.sum(torch.where(free_w & (free_before == r[..., None]), widx, 0), dim=-1, dtype=torch.int32)
    accept = any_match | claim_ok
    way = torch.where(any_match, exist_way, claim_way)

    # existing moments of my way (zeros for claims)
    base = (way * _STRIDE)[..., None]  # (B, n, 1)
    mom_cols = base + torch.arange(2, 11, dtype=torch.int32, device=dev)
    old_mom = torch.gather(g, -1, mom_cols.long()).view(torch.float32)
    old_mom = torch.where(any_match[..., None], old_mom, 0.0)

    s_xyz = gather_rows(pc.xyz, sidx)
    dedup = min_distance > 0
    if dedup:
        md = on_device(float(min_distance), torch.float32, dev)
        G = torch.clamp(torch.floor(m.voxel_size / md).to(torch.int32), 1, _DEDUP_MAX_G).view(B, 1)
        s_coords = voxel_coords(s_xyz, vs)
        f = s_xyz / vs - s_coords.to(torch.float32)  # [0, 1) per axis
        cell = torch.minimum(torch.clamp((f * G[..., None].to(torch.float32)).to(torch.int32), min=0), G[..., None] - 1)
        bit = (cell[..., 0] * G + cell[..., 1]) * G + cell[..., 2]  # (B, n)
        lane_off = bit >> 5
        bmask = _wrap_i32(torch.ones_like(bit, dtype=torch.int64) << (bit & 31).to(torch.int64)).to(torch.int32)
        lane_iota = torch.arange(_DEDUP_LANES, dtype=torch.int32, device=dev)
        bit_cols = base + _DEDUP_LANE0 + lane_iota
        old_bits = torch.where(any_match[..., None], torch.gather(g, -1, bit_cols.long()), 0)  # (B, n, 14)
        mine = lane_iota == lane_off[..., None]
        my_old = torch.sum(torch.where(mine, old_bits, 0), dim=-1, dtype=torch.int32)
        too_close = s_valid & ((my_old & bmask) != 0)
        accept = accept & ~too_close
        my_bits = torch.where(mine & accept[..., None], bmask[..., None], 0)
    else:
        too_close = torch.zeros_like(accept)

    ctr = (coords.to(torch.float32) + 0.5) * vs
    s_ctr = gather_rows(ctr, sidx)
    rel = torch.where(accept[..., None], s_xyz - s_ctr, 0.0)
    x, y, z = rel.unbind(-1)
    a32 = accept.to(torch.int32)
    self_row = torch.cat(
        [rel, torch.stack([x * x, y * y, z * z, x * y, x * z, y * z, a32.to(torch.float32)], -1)], dim=-1
    )  # (B, n, 10): moment sums + count
    tot = _seg_total(self_row, is_voxel_head)
    new_mom = old_mom + tot[..., :9]
    n_new = torch.clamp(n_exist + tot[..., 9].to(torch.int32), max=_MAX_N)

    # plane of the touched voxel (every subrun member computes the same)
    nf = torch.clamp(n_new.to(torch.float32), min=1.0)[..., None]
    mean_rel = new_mom[..., :3] / nf
    mx, my, mz = mean_rel.unbind(-1)
    mm = torch.stack([mx, my, mz, mx, mx, my], -1)
    mn = torch.stack([mx, my, mz, my, mz, mz], -1)
    cov6 = se3.fma_f32(-mm, mn, new_mom[..., 3:9] / nf)  # XLA fuses the product into the subtraction
    nrm, e_min, e_mid = linalg.sym_eigen_smallest(cov6)
    ok = (
        (n_new >= NdtMap.MIN_POINTS_FOR_PLANE)
        & (e_min >= -1e-6)
        & (e_min <= m.max_eigen_ratio[:, None] * torch.clamp(e_mid, min=1e-12))
    )
    mean_g = s_ctr + mean_rel
    state_fin = _wrap_i32((e16.to(torch.int64) << 16) | n_new.to(torch.int64)).to(torch.int32)

    vals_f32 = torch.cat([new_mom, mean_g, nrm], dim=-1).contiguous()  # (B, n, 15)
    parts = [spk[..., None], state_fin[..., None], vals_f32.view(torch.int32), ok.to(torch.int32)[..., None]]
    write = accept
    if dedup:
        # a fully deduplicated live voxel still refreshes its state lane
        parts.append(old_bits | _seg_or_total(my_bits, is_voxel_head))
        write = accept | (too_close & any_match)
    vals = torch.cat(parts, dim=-1)  # (B, n, 18 or 32)
    # the members of a voxel compute its totals with rounding that depends
    # on their place in the scans; XLA's scatter applies the updates in
    # order, so the voxel's last writing member lands: write only that one
    w32 = write.to(torch.int32)
    write = write & (_seg_cumsum_reverse(w32, is_voxel_tail) == w32)
    n_lanes = vals.shape[-1]
    p_base = (s_bucket * W + way) * _STRIDE
    lane = torch.arange(n_lanes, dtype=torch.int32, device=dev)
    idx = torch.where(write[..., None], p_base[..., None] + lane, _SINK)
    vals = torch.where(write[..., None], vals, 0)
    L = m.data.shape[1] * 128
    flat_idx = idx.to(torch.int64) + torch.arange(B, device=dev).view(B, 1, 1) * L
    m.data.view(-1).index_put_((flat_idx.view(-1),), vals.reshape(-1))

    zero = torch.zeros((B,), dtype=torch.int32, device=dev)
    stats = InsertStats(
        # min_distance rejections are intended, not capacity pressure
        collision_drops=torch.sum(s_valid & ~accept & ~too_close, dim=-1, dtype=torch.int32),
        full_drops=zero,  # moments accumulate unbounded (n capped)
        deferred_drops=zero,
    )
    return m, stats


def prune_farther_than(m: NdtMap, center: torch.Tensor, distance) -> NdtMap:
    """Drop voxels whose center lies farther than ``distance`` (L-inf, as
    the JAX package; ``<= 0`` disables) from ``center`` (B, 3) by zeroing
    their state lanes, in place."""
    B = m.data.shape[0]
    w = m.windows()
    pkey, state = w[..., 0], w[..., 1]
    live = ((state >> 16) & 0xFFFF) == m.epoch16[:, None]
    vs = m.voxel_size
    cvox = voxel_coords(center, vs[:, None])
    kvox = unpack_key_near(pkey, cvox[:, None, :])
    centers = (kvox.to(torch.float32) + 0.5) * vs[:, None, None]
    l1 = torch.amax(torch.abs(centers - center[:, None, :]), dim=-1)
    dist = on_device(distance, torch.float32, m.data.device).expand(B)[:, None]
    kill = live & (l1 > dist) & (dist > 0)
    w[..., 1] = torch.where(kill, 0, state)
    return m


class NdtCandSet(NamedTuple):
    """Cached neighbourhood Gaussians of a query batch (one gather)."""

    mu: torch.Tensor  # (B, N, P, 3) voxel means
    nrm: torch.Tensor  # (B, N, P, 3) plane normals
    live: torch.Tensor  # (B, N, P) slot live + key match
    plane_ok: torch.Tensor  # (B, N, P)


def capture(m: NdtMap, queries: torch.Tensor, neighbors: int = 27) -> NdtCandSet:
    """Gather the probed voxels' means and planes around ``queries`` (B, N, 3)."""
    B, N, _ = queries.shape
    vs = m.voxel_size.view(B, 1, 1)
    base = voxel_coords(queries, vs)
    cand = neighbor_coords(queries, base, vs, neighbors)  # (B, N, P, 3)
    P = cand.shape[2]
    buckets = voxel_hash(cand, m.num_buckets)
    gb = gather_rows(m.data, buckets.view(B, N * P)).view(B, N, P, _WAYS, _STRIDE)
    target = pack_key(cand)
    e16 = m.epoch16.view(B, 1, 1, 1)
    ok_w = (gb[..., 0] == target[..., None]) & (((gb[..., 1] >> 16) & 0xFFFF) == e16)
    g = gb[..., 0, :18]
    for w in range(1, _WAYS):
        g = torch.where(ok_w[..., w, None], gb[..., w, :18], g)
    live = torch.any(ok_w, dim=-1) & ((g[..., 1] & 0xFFFF) > 0)
    f = g[..., 11:17].contiguous().view(torch.float32)
    return NdtCandSet(f[..., :3], f[..., 3:], live, live & (g[..., 17] > 0))


def _pick(t: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """``t[b, n, j[b, n]]`` of (B, N, P, 3) ``t``."""
    return torch.gather(t, 2, j[..., None, None].expand(-1, -1, 1, 3))[:, :, 0]


def _nearest(mu: torch.Tensor, queries: torch.Tensor, mask: torch.Tensor):
    """Squared distance to the nearest masked mean and its lowest index."""
    d = mu - queries[:, :, None, :]
    d2 = torch.where(mask, se3.dot3(d, d), torch.inf)
    dmin = torch.amin(d2, dim=-1, keepdim=True)
    P = d2.shape[-1]
    lane = torch.arange(P, device=d2.device)
    j = torch.amin(torch.where(d2 <= dmin, lane, P), dim=-1)
    return dmin[..., 0], torch.clamp(j, max=P - 1)


def p2p_from(cand: NdtCandSet, queries: torch.Tensor, valid: torch.Tensor):
    """Nearest cached voxel mean per query (point-to-point fallback):
    ``(tgt (B, N, 3), d2 (B, N), found)``."""
    dmin, j = _nearest(cand.mu, queries, cand.live)
    found = valid & torch.isfinite(dmin)
    return _pick(cand.mu, j), torch.where(found, dmin, torch.inf), found


def p2pl_from(cand: NdtCandSet, queries: torch.Tensor, valid: torch.Tensor):
    """Nearest cached plane per query (Matcher_Point2Plane against NDT):
    ``(plane_pt, normal, dist2, found)``; ``plane_pt`` is the query's
    projection on the plane and ``dist2`` the squared point-plane distance
    (what ``distanceThreshold`` gates on)."""
    dmin, j = _nearest(cand.mu, queries, cand.plane_ok)
    best_mu, best_nrm = _pick(cand.mu, j), _pick(cand.nrm, j)
    found = valid & torch.isfinite(dmin)
    dpl = se3.dot3(best_nrm, queries - best_mu)  # signed plane distance
    plane_pt = se3.fma_f32(-dpl[..., None].expand_as(best_nrm), best_nrm, queries)  # as XLA fuses it
    return plane_pt, best_nrm, torch.where(found, dpl * dpl, torch.inf), found


def query_p2p(m: NdtMap, queries: torch.Tensor, valid: torch.Tensor, *, neighbors: int = 27):
    """Single-shot nearest-mean query."""
    return p2p_from(capture(m, queries, neighbors), queries, valid)


def query_p2pl(m: NdtMap, queries: torch.Tensor, valid: torch.Tensor, *, neighbors: int = 27):
    """Single-shot nearest-plane query."""
    return p2pl_from(capture(m, queries, neighbors), queries, valid)
