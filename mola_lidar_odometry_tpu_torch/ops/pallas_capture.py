"""Kernels B1 and B2: fused neighbourhood capture and its phase-2 reselect.

Port of ``mola_lidar_odometry_tpu/ops/pallas_capture.py``
(``capture_planar``, ``pallas_call`` at :257, and ``capture_planar_reselect``,
:335).  For every query and each of its P probed voxels: pick the bucket way
whose ``pkey`` and epoch match the probe, dequantize its K packed points
against the probe voxel, and keep the two nearest (first-min tie-break).
Results come out planar, ``(B, 2P, npad)`` per coordinate plane, top-1 block
over top-2 block — the layout the align kernel (B3) reads.

Two CUDA kernels (``csrc/capture.cu``), both bound by bytes, selecting
through one shared device function:

  * B1 (``capture_gather_kernel``) runs one thread per (instance, probe,
    query) for the arithmetic; each thread moves its query's 512-byte bucket
    row into shared memory and on to the rows for B2 with two TMA bulk
    copies (the row gather that the JAX package left to XLA is fused in),
    and selects its own top-2 with two serial scans (:func:`capture_geometry`
    gives the launch shape).  It reads the distinct probed rows and writes
    B·P·npad rows of 512 B (about 100 MB at the bench shape);
  * B2 (``reselect_kernel``) runs one thread per (instance, probe, query) on
    the rows B1 wrote and reads only what its selection needs: the W way
    headers' 32-byte sectors, then the selected way's further point words
    k < cnt (:func:`reselect_geometry` gives the launch shape,
    :func:`reselect_sectors` counts the sectors for given inputs);
  * FMA contraction is off in that file, so the key derivation
    ``floor(q * inv_vs)``, the octant test ``q * inv_vs - (b + 0.5)`` and the
    dequantization ``(e + (p + 0.5) / 1024) * vs`` round exactly as in the
    plain twin: kernels and twin agree bit for bit.

Like the JAX package, B1 picks the bucket ROW from ``floor(q / vs)`` (the
XLA gather's voxel coords) but derives the EXPECTED key inside the kernel
from ``floor(q * (1 / vs))``; for voxel sizes that are not powers of two the
two can disagree on rare points, and the port reproduces that behaviour.

``capture_planar``/``capture_planar_reselect`` launch the kernel for CUDA
tensors and run the plain twin (``*_plain``) for CPU tensors.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from mola_lidar_odometry_tpu_torch.ops import cuda_build
from mola_lidar_odometry_tpu_torch.ops.filters import _wrap_i32, voxel_coords, voxel_hash
from mola_lidar_odometry_tpu_torch.ops.pointcloud import gather_rows, on_device
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
        return on_device(_OFFS27, torch.float32, device), False
    if neighbors == 8:
        return on_device(_CORNERS8, torch.float32, device), True
    if neighbors == 4:
        return on_device(_FACES4, torch.float32, device), True
    if neighbors == 1:
        return torch.zeros((1, 3), dtype=torch.float32, device=device), False
    raise ValueError(f"neighbors must be 1, 4, 8 or 27, got {neighbors}")


def _check_layout(K: int, stride: int) -> None:
    if 128 % stride or not 2 + K <= stride <= 128:
        raise ValueError((K, stride))


def _pad_points(x: torch.Tensor, npad: int) -> torch.Tensor:
    return torch.nn.functional.pad(x, (0, 0, 0, npad - x.shape[1]))


def _select_way(rows, q_cap, voxel_size, epoch, neighbors, stride):
    """The way select of the kernel body: rows (B, P, npad, 128) i32, q_cap
    (B, npad, 3) -> the probe voxels ``e`` (3 x (B, P, npad) f32), the
    selected way's words (B, P, npad, stride) and whether any way matched."""
    B, P, npad, _ = rows.shape
    dev = rows.device
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
    return e, half, torch.any(ok_w, dim=-1)


def _select_top2(rows, q_live, q_cap, voxel_size, epoch, neighbors, K, stride):
    """The kernel body as plain tensor code: rows (B, P, npad, 128) i32,
    q_live/q_cap (B, npad, 3) -> planes (B, 8, P, npad)
    [x1, y1, z1, m1, x2, y2, z2, m2]."""
    B = rows.shape[0]
    dev = rows.device
    e, half, any_ok = _select_way(rows, q_cap, voxel_size, epoch, neighbors, stride)
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


def reselect_sectors(rows, voxel_size, epoch, queries_cap, neighbors: int = 8, K: int = 20,
                     stride: int = 32) -> Tuple[int, int]:
    """What kernel B2 reads of ``rows`` for these inputs, by the plain way
    select: ``(sectors, words)``.  Each probe reads its W way-header 32-byte
    sectors (pkey, state, point words 0-5); a live probe also reads the
    further sectors of its way that hold a word k < min(cnt, K).  ``words``
    counts those live point words."""
    _check_layout(K, stride)
    npad = rows.shape[2]
    _, half, any_ok = _select_way(rows, _pad_points(queries_cap, npad), voxel_size, epoch, neighbors, stride)
    cnt = half[..., 1] & 0xFFFF
    nk = torch.where(any_ok & (cnt > 0), torch.clamp(cnt, max=K), 0).long()
    extra = (2 + nk + 7) // 8 - 1  # sectors of the way past its header sector
    return int((128 // stride) * nk.numel() + extra.sum()), int(nk.sum())


# ---------------------------------------------------------------------------
# the CUDA kernels (csrc/capture.cu)
# ---------------------------------------------------------------------------


GATHER_WARPS = 2  # csrc/capture.cu kGatherWarps: warps per block of B1
ROW_STRIDE_BYTES = 512 + 16  # a staged row and its 16 bytes of padding


class CaptureGeometry(NamedTuple):
    grid: Tuple[int, int, int]  # (query blocks, probes, instances)
    threads: int  # per block; one query per thread
    smem_bytes: int  # static shared memory per block: each warp's 32 staged rows


def capture_geometry(B: int, P: int, npad: int) -> CaptureGeometry:
    """Launch shape of kernel B1 (``capture_launch`` computes the same)."""
    per_block = 32 * GATHER_WARPS
    if P > 65535 or B > 65535:
        raise ValueError(f"capture kernel: P={P}, B={B} exceed the grid's y/z limits")
    return CaptureGeometry((-(-npad // per_block), P, B), per_block, per_block * ROW_STRIDE_BYTES)


RESELECT_THREADS = 128  # csrc/capture.cu kReselectThreads: queries per block of B2
RESELECT_STRIDES = (32, 64, 128)  # the way layouts of VoxelHashMap.create: 4, 2 or 1 ways


class ReselectGeometry(NamedTuple):
    grid: Tuple[int, int, int]  # (query blocks, probes, instances)
    threads: int  # per block; one query per thread


def reselect_geometry(B: int, P: int, npad: int) -> ReselectGeometry:
    """Launch shape of kernel B2 (``reselect_launch`` computes the same)."""
    if P > 65535 or B > 65535 or B * P * npad >= 1 << 31:
        raise ValueError(f"reselect kernel: B={B}, P={P}, npad={npad} exceed the grid or 32-bit row indices")
    return ReselectGeometry((-(-npad // RESELECT_THREADS), P, B), RESELECT_THREADS)


def _check(B, n, npad, neighbors, K, voxel_size, epoch, q_live, q_cap, valid, tensors):
    """The checks both kernels share; returns ``valid`` as uint8 (or None)."""
    dev = q_live.device
    for name, t, dt in tensors + (
        ("voxel_size", voxel_size, torch.float32), ("epoch", epoch, torch.int32),
        ("queries", q_live, torch.float32), ("queries_cap", q_cap, torch.float32),
    ):
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"capture kernel: {name} must be contiguous {dt} on {dev}")
    if neighbors not in (1, 4, 8, 27) or npad < n:
        raise ValueError(f"capture kernel: neighbors={neighbors}, npad={npad} < N={n}")
    if voxel_size.shape != (B,) or epoch.shape != (B,) or q_cap.shape != q_live.shape:
        raise ValueError("capture kernel: per-instance shapes disagree")
    if valid is None:
        return None
    if valid.shape != (B, n) or valid.device != dev:
        raise ValueError("capture kernel: valid must be (B, N) on the queries' device")
    return valid.to(torch.uint8).contiguous()


def _opt(t):
    return None if t is None else cuda_build.ptr(t)


def capture_planar(
    data, voxel_size, epoch, queries, neighbors: int = 27, tile_q: int = 256, K: int = 20,
    stride: int = 32, valid=None, return_rows: bool = False,
):
    """Kernel B1 (see :func:`capture_planar_plain` for the contract)."""
    if not queries.is_cuda:
        return capture_planar_plain(
            data, voxel_size, epoch, queries, neighbors, tile_q, K, stride, valid, return_rows
        )
    launch, result = capture_launcher(data, voxel_size, epoch, queries, neighbors, tile_q, K, stride,
                                      valid, return_rows)
    launch()
    capture_planar.launches += 1
    return result()


def capture_launcher(
    data, voxel_size, epoch, queries, neighbors: int = 27, tile_q: int = 256, K: int = 20,
    stride: int = 32, valid=None, return_rows: bool = False,
):
    """Check the inputs of kernel B1 and allocate its outputs once; returns
    ``(launch, result)``: ``launch()`` runs ``capture_gather_kernel`` on the
    current stream (it raises on a refused launch), ``result()`` returns the
    outputs of the last launch as :func:`capture_planar` does."""
    _check_layout(K, stride)
    B, n, _ = queries.shape
    npad = _npad(n, tile_q)
    P = neighbors  # one probe per neighbour voxel
    dev = queries.device
    if data.dim() != 3 or data.shape[2] != 128 or data.shape[0] != B:
        raise ValueError(f"capture kernel: table must be (B, rows, 128), got {tuple(data.shape)}")
    valid_u8 = _check(B, n, npad, neighbors, K, voxel_size, epoch, queries, queries, valid,
                      (("table", data, torch.int32),))
    capture_geometry(B, P, npad)
    rows = torch.empty((B, P, npad, 128), dtype=torch.int32, device=dev) if return_rows else None
    planes = torch.empty((4, B, 2 * P, npad), dtype=torch.float32, device=dev)
    fn = cuda_build.load("capture").capture_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    inv_vs = (1.0 / voxel_size).contiguous()
    p = cuda_build.ptr
    argv = (
        p(data), p(voxel_size), p(inv_vs), p(epoch), p(queries), _opt(valid_u8), _opt(rows),
        *(p(pl) for pl in planes), B, n, npad, P, neighbors, K, stride, data.shape[1],
        int(valid is not None),
    )

    def launch():
        cuda_build.launch(fn, argv, dev, "capture_gather_kernel")

    launch.tensors = (data, voxel_size, inv_vs, epoch, queries, valid_u8, rows, planes)

    def result():
        return tuple(planes) + (rows,) if return_rows else tuple(planes)

    return launch, result


def capture_planar_reselect(
    rows, voxel_size, epoch, queries_live, queries_cap, neighbors: int = 8, K: int = 20,
    stride: int = 32, valid=None,
):
    """Kernel B2 (see :func:`capture_planar_reselect_plain`)."""
    if not queries_live.is_cuda:
        return capture_planar_reselect_plain(
            rows, voxel_size, epoch, queries_live, queries_cap, neighbors, K, stride, valid
        )
    launch, result = reselect_launcher(rows, voxel_size, epoch, queries_live, queries_cap, neighbors, K,
                                       stride, valid)
    launch()
    capture_planar_reselect.launches += 1
    return result()


def reselect_launcher(
    rows, voxel_size, epoch, queries_live, queries_cap, neighbors: int = 8, K: int = 20,
    stride: int = 32, valid=None,
):
    """Check the inputs of kernel B2 and allocate its outputs once; returns
    ``(launch, result)``: ``launch()`` runs ``reselect_kernel`` on the current
    stream (it raises on a refused launch), ``result()`` returns the planes of
    the last launch as :func:`capture_planar_reselect` does."""
    _check_layout(K, stride)
    if stride not in RESELECT_STRIDES:
        raise ValueError(f"reselect kernel: stride {stride} is none of {RESELECT_STRIDES}")
    B, P, npad, w = rows.shape
    if w != 128 or P != neighbors or B != queries_live.shape[0]:
        raise ValueError(f"reselect kernel: rows must be (B, P, npad, 128), got {tuple(rows.shape)}")
    n = queries_live.shape[1]
    dev = queries_live.device
    valid_u8 = _check(B, n, npad, neighbors, K, voxel_size, epoch, queries_live, queries_cap, valid,
                      (("rows", rows, torch.int32),))
    reselect_geometry(B, P, npad)
    planes = torch.empty((4, B, 2 * P, npad), dtype=torch.float32, device=dev)
    fn = cuda_build.load("capture").reselect_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    inv_vs = (1.0 / voxel_size).contiguous()
    p = cuda_build.ptr
    argv = (
        p(rows), p(voxel_size), p(inv_vs), p(epoch), p(queries_live), p(queries_cap), _opt(valid_u8),
        *(p(pl) for pl in planes), B, n, npad, P, neighbors, K, stride, int(valid is not None),
    )

    def launch():
        cuda_build.launch(fn, argv, dev, "reselect_kernel")

    launch.tensors = (rows, voxel_size, inv_vs, epoch, queries_live, queries_cap, valid_u8, planes)

    def result():
        return tuple(planes)

    return launch, result


capture_planar.launches = 0
capture_planar_reselect.launches = 0
