"""Kernels B1 and B2: fused neighbourhood capture and its phase-2 reselect.

Port of ``mola_lidar_odometry_tpu/ops/pallas_capture.py``
(``capture_planar``, ``pallas_call`` at :257, and ``capture_planar_reselect``,
:335).  For every query and each of its P probed voxels: pick the bucket way
whose ``pkey`` and epoch match the probe, dequantize its K packed points
against the probe voxel, and keep the two nearest (first-min tie-break).
Results come out planar, ``(B, 2P, npad)`` per coordinate plane, top-1 block
over top-2 block — the layout the align kernel (B3) reads.

One CUDA kernel (``csrc/capture.cu``) serves both, with a ``reselect`` flag:

  * one warp per (instance, probe, query); the warp reads the 512-byte
    bucket row with one 16-byte load per lane (the row gather that the JAX
    package left to XLA is fused in), optionally writes it out for B2,
    shuffles the matched way's K point words to K lanes, and reduces the
    top-2 with two warp argmin butterflies;
  * bound by bytes: B1 reads and writes B·P·npad rows of 512 B (about
    100 MB each at the bench shape), B2 reads them back; the arithmetic is
    a few dozen operations per row;
  * FMA contraction is off in that file, so the key derivation
    ``floor(q * inv_vs)``, the octant test ``q * inv_vs - (b + 0.5)`` and the
    dequantization ``(e + (p + 0.5) / 1024) * vs`` round exactly as in the
    plain twin: kernel and twin agree bit for bit.

Like the JAX package, B1 picks the bucket ROW from ``floor(q / vs)`` (the
XLA gather's voxel coords) but derives the EXPECTED key inside the kernel
from ``floor(q * (1 / vs))``; for voxel sizes that are not powers of two the
two can disagree on rare points, and the port reproduces that behaviour.

``capture_planar``/``capture_planar_reselect`` launch the kernel for CUDA
tensors and run the plain twin (``*_plain``) for CPU tensors.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from mola_lidar_odometry_tpu_torch.ops import cuda_build
from mola_lidar_odometry_tpu_torch.ops.filters import _wrap_i32, voxel_coords, voxel_hash
from mola_lidar_odometry_tpu_torch.ops.pointcloud import gather_rows
from mola_lidar_odometry_tpu_torch.ops.voxel_hash import _CORNERS8, _FACES4, _OFFS27, neighbor_coords

BIG = 3.4e38
_QBITS = 10
_Q = 1 << _QBITS
_INV_Q = 1.0 / _Q


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _npad(n: int, tile_q: int) -> int:
    tq = min(tile_q, _round_up(max(n, 128), 128))
    return _round_up(max(n, tq), tq)


def _probe_offsets(neighbors: int, device) -> Tuple[torch.Tensor, bool]:
    """(P, 3) f32 probe offsets and whether they flip with the query octant."""
    if neighbors == 27:
        return torch.tensor(_OFFS27, dtype=torch.float32, device=device), False
    if neighbors == 8:
        return torch.tensor(_CORNERS8, dtype=torch.float32, device=device), True
    if neighbors == 4:
        return torch.tensor(_FACES4, dtype=torch.float32, device=device), True
    if neighbors == 1:
        return torch.zeros((1, 3), dtype=torch.float32, device=device), False
    raise ValueError(f"neighbors must be 1, 4, 8 or 27, got {neighbors}")


def _check_layout(K: int, stride: int) -> None:
    if 128 % stride or not 2 + K <= stride <= 128:
        raise ValueError((K, stride))


def _pad_points(x: torch.Tensor, npad: int) -> torch.Tensor:
    return torch.nn.functional.pad(x, (0, 0, 0, npad - x.shape[1]))


def _select_top2(rows, q_live, q_cap, voxel_size, epoch, neighbors, K, stride):
    """The kernel body as plain tensor code: rows (B, P, npad, 128) i32,
    q_live/q_cap (B, npad, 3) -> planes (B, 8, P, npad)
    [x1, y1, z1, m1, x2, y2, z2, m2]."""
    B, P, npad, _ = rows.shape
    dev = rows.device
    vs = voxel_size.view(B, 1, 1)
    inv_vs = (1.0 / voxel_size).view(B, 1, 1)
    offs, signed = _probe_offsets(neighbors, dev)
    e = []
    for a in range(3):
        cq = q_cap[..., a][:, None, :]  # (B, 1, npad)
        t = cq * inv_vs
        base = torch.floor(t)
        sgn = torch.where(t - (base + 0.5) >= 0, 1.0, -1.0) if signed else torch.ones_like(base)
        e.append(base + offs[:, a].view(1, P, 1) * sgn)  # (B, P, npad) f32
    ik = [x.to(torch.int64) for x in e]
    pk_exp = _wrap_i32(((ik[0] & 4095) << 20) | ((ik[1] & 4095) << 8) | (ik[2] & 255)).to(torch.int32)

    W = 128 // stride
    r = rows.view(B, P, npad, W, stride)
    e16 = (epoch & 0xFFFF).view(B, 1, 1, 1)
    ok_w = (r[..., 0] == pk_exp[..., None]) & (((r[..., 1] >> 16) & 0xFFFF) == e16)
    half = r[..., 0, :]
    for w in range(1, W):
        half = torch.where(ok_w[..., w, None], r[..., w, :], half)
    any_ok = torch.any(ok_w, dim=-1)
    cnt = (half[..., 1] & 0xFFFF).to(torch.float32)
    pp = half[..., 2 : 2 + K]  # (B, P, npad, K)
    kio = torch.arange(K, device=dev)
    kmask = (any_ok & (cnt > 0))[..., None] & (kio.to(torch.float32) < cnt[..., None])
    vs4 = voxel_size.view(B, 1, 1, 1)
    xs, d2 = [], None
    for a, sh in enumerate((2 * _QBITS, _QBITS, 0)):
        pq = ((pp >> sh) & (_Q - 1)).to(torch.float32)
        x = (e[a][..., None] + (pq + 0.5) * _INV_Q) * vs4
        xs.append(x)
        d = x - q_live[..., a][:, None, :, None]
        d2 = d * d if d2 is None else d2 + d * d
    d2 = torch.where(kmask, d2, BIG)

    def pick(d2m):
        dmin = torch.amin(d2m, dim=-1, keepdim=True)
        first = torch.amin(torch.where(d2m <= dmin, kio, K), dim=-1, keepdim=True)
        sel = [torch.gather(x, -1, first)[..., 0] for x in xs]
        return sel, (dmin[..., 0] < BIG).to(torch.float32), first

    (x1, y1, z1), m1, first = pick(d2)
    (x2, y2, z2), m2, _ = pick(torch.where(kio == first, BIG, d2))
    return torch.stack([x1, y1, z1, m1, x2, y2, z2, m2], dim=1)


def _to_planar(out: torch.Tensor, vmask) -> Tuple[torch.Tensor, ...]:
    cx = torch.cat([out[:, 0], out[:, 4]], dim=1)
    cy = torch.cat([out[:, 1], out[:, 5]], dim=1)
    cz = torch.cat([out[:, 2], out[:, 6]], dim=1)
    cm = torch.cat([out[:, 3], out[:, 7]], dim=1)
    if vmask is not None:
        cm = cm * vmask[:, None, :].to(cm.dtype)
    return cx, cy, cz, cm


def capture_planar_plain(
    data: torch.Tensor,  # (B, rows, 128) i32 map tables
    voxel_size: torch.Tensor,  # (B,) f32
    epoch: torch.Tensor,  # (B,) i32
    queries: torch.Tensor,  # (B, N, 3) f32 map-frame query points
    neighbors: int = 27,
    tile_q: int = 256,
    K: int = 20,
    stride: int = 32,
    valid: torch.Tensor = None,  # (B, N) bool — invalid queries are spread-padded
    return_rows: bool = False,
):
    """Plain twin of kernel B1: returns ``(cx, cy, cz, cm)``, each
    ``(B, 2P, npad)`` f32 (plus the gathered rows ``(B, P, npad, 128)`` i32
    with ``return_rows``)."""
    _check_layout(K, stride)
    B, n, _ = queries.shape
    NB = data.shape[1]
    npad = _npad(n, tile_q)
    q = _pad_points(queries, npad)
    vs = voxel_size.view(B, 1, 1)
    base = voxel_coords(q, vs)
    cand = neighbor_coords(q, base, vs, neighbors)  # (B, npad, P, 3)
    P = cand.shape[2]
    buckets = voxel_hash(cand, NB)
    vmask = None
    if valid is not None:
        vmask = torch.nn.functional.pad(valid, (0, npad - n))
        spread = (
            torch.arange(npad, device=q.device)[:, None] * P + torch.arange(P, device=q.device)
        ) % NB
        buckets = torch.where(vmask[..., None], buckets, spread.to(torch.int32))
    rows = gather_rows(data, buckets.transpose(1, 2))  # (B, P, npad, 128)
    planes = _to_planar(_select_top2(rows, q, q, voxel_size, epoch, neighbors, K, stride), vmask)
    return planes + (rows,) if return_rows else planes


def capture_planar_reselect_plain(
    rows: torch.Tensor,  # (B, P, npad, 128) i32 — gathered by capture_planar
    voxel_size: torch.Tensor,
    epoch: torch.Tensor,
    queries_live: torch.Tensor,  # (B, N, 3) — positions to rank distances from
    queries_cap: torch.Tensor,  # (B, N, 3) — positions the rows were gathered for
    neighbors: int = 8,
    K: int = 20,
    stride: int = 32,
    valid: torch.Tensor = None,
):
    """Plain twin of kernel B2: re-rank the top-2 per probed voxel on rows
    already gathered, keys from ``queries_cap``, distances from
    ``queries_live``."""
    _check_layout(K, stride)
    npad = rows.shape[2]
    n = queries_live.shape[1]
    ql, qc = _pad_points(queries_live, npad), _pad_points(queries_cap, npad)
    vmask = None if valid is None else torch.nn.functional.pad(valid, (0, npad - n))
    return _to_planar(_select_top2(rows, ql, qc, voxel_size, epoch, neighbors, K, stride), vmask)


# ---------------------------------------------------------------------------
# the CUDA kernel (csrc/capture.cu)
# ---------------------------------------------------------------------------


def _launch(src, voxel_size, epoch, q_live, q_cap, valid, neighbors, K, stride, npad,
            reselect, rows_out):
    """Check the inputs and launch ``capture_kernel`` on the current stream;
    ``src`` is the table (B1) or the B1 rows (B2)."""
    B, n, _ = q_live.shape
    P = neighbors  # one probe per neighbour voxel
    dev = q_live.device
    for name, t, dt in (
        ("table/rows", src, torch.int32), ("voxel_size", voxel_size, torch.float32),
        ("epoch", epoch, torch.int32), ("queries", q_live, torch.float32),
        ("queries_cap", q_cap, torch.float32),
    ):
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"capture kernel: {name} must be contiguous {dt} on {dev}")
    if K > 32:
        raise ValueError(f"capture kernel: K={K} > 32 points per voxel (one warp lane each)")
    if neighbors not in (1, 4, 8, 27) or npad < n:
        raise ValueError(f"capture kernel: neighbors={neighbors}, npad={npad} < N={n}")
    if voxel_size.shape != (B,) or epoch.shape != (B,) or q_cap.shape != q_live.shape:
        raise ValueError("capture kernel: per-instance shapes disagree")
    valid_u8 = None
    if valid is not None:
        if valid.shape != (B, n) or valid.device != dev:
            raise ValueError("capture kernel: valid must be (B, N) on the queries' device")
        valid_u8 = valid.to(torch.uint8).contiguous()
    inv_vs = (1.0 / voxel_size).contiguous()
    planes = torch.empty((4, B, 2 * P, npad), dtype=torch.float32, device=dev)
    fn = cuda_build.load("capture").capture_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    opt = lambda t: None if t is None else cuda_build.ptr(t)  # noqa: E731
    err = fn(
        cuda_build.ptr(src), cuda_build.ptr(voxel_size), cuda_build.ptr(inv_vs),
        cuda_build.ptr(epoch), cuda_build.ptr(q_live), cuda_build.ptr(q_cap),
        opt(valid_u8), opt(rows_out), *(cuda_build.ptr(pl) for pl in planes),
        B, n, npad, P, neighbors, K, stride, 0 if reselect else src.shape[1],
        int(reselect), int(valid is not None), cuda_build.stream_ptr(dev),
    )
    cuda_build.check(err, "capture_kernel")
    return tuple(planes)


def capture_planar(
    data, voxel_size, epoch, queries, neighbors: int = 27, tile_q: int = 256, K: int = 20,
    stride: int = 32, valid=None, return_rows: bool = False,
):
    """Kernel B1 (see :func:`capture_planar_plain` for the contract)."""
    if not queries.is_cuda:
        return capture_planar_plain(
            data, voxel_size, epoch, queries, neighbors, tile_q, K, stride, valid, return_rows
        )
    _check_layout(K, stride)
    B, n, _ = queries.shape
    npad = _npad(n, tile_q)
    P = neighbors  # one probe per neighbour voxel
    rows = (
        torch.empty((B, P, npad, 128), dtype=torch.int32, device=queries.device) if return_rows else None
    )
    if data.dim() != 3 or data.shape[2] != 128 or data.shape[0] != B:
        raise ValueError(f"capture kernel: table must be (B, rows, 128), got {tuple(data.shape)}")
    planes = _launch(data, voxel_size, epoch, queries, queries, valid, neighbors, K, stride,
                     npad, False, rows)
    capture_planar.launches += 1
    return planes + (rows,) if return_rows else planes


def capture_planar_reselect(
    rows, voxel_size, epoch, queries_live, queries_cap, neighbors: int = 8, K: int = 20,
    stride: int = 32, valid=None,
):
    """Kernel B2 (see :func:`capture_planar_reselect_plain`)."""
    if not queries_live.is_cuda:
        return capture_planar_reselect_plain(
            rows, voxel_size, epoch, queries_live, queries_cap, neighbors, K, stride, valid
        )
    _check_layout(K, stride)
    B, P, npad, w = rows.shape
    if w != 128 or P != neighbors or B != queries_live.shape[0]:
        raise ValueError(f"reselect kernel: rows must be (B, P, npad, 128), got {tuple(rows.shape)}")
    planes = _launch(rows, voxel_size, epoch, queries_live, queries_cap, valid, neighbors, K,
                     stride, npad, True, None)
    capture_planar_reselect.launches += 1
    return planes


capture_planar.launches = 0
capture_planar_reselect.launches = 0
