"""Kernel B4: fused nearest-candidate selection for the generic ICP loop.

Port of ``mola_lidar_odometry_tpu/ops/pallas_match.py`` (``nn_select``,
``pallas_call`` at :109, body ``_nn_kernel`` :66-83).  The per-iteration hot
op of the generic align loop is "for each scan point, the nearest cached
candidate and its squared distance"; the candidates are captured once per
align and turned into PLANAR per-coordinate planes (:func:`to_planar`), and
every iteration runs one select over them.

Per (instance, query): ``d2 = (dx*dx + dy*dy) + dz*dz`` to each of the C
candidates, masked candidates set to ``3.4e38``, the row minimum and the
FIRST candidate attaining it.  A query with no live candidate returns
``d2min = 3.4e38`` (not inf) and candidate 0's coordinates.

The TPU kernel pads C and N to multiples of 128 for its lane layout; that is
layout, not semantics, so the port's planes are unpadded ``(B, N, C)`` and
the CUDA kernel (``csrc/match.cu``, one warp per query, built without FMA
contraction) takes any N and C.  It is bound by bytes: 16 bytes of planes
per candidate against 9 flops.

:func:`nn_select` launches the kernel for CUDA tensors and runs the plain
twin :func:`nn_select_plain` for CPU tensors; kernel and twin agree bit for
bit.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from mola_lidar_odometry_tpu_torch.ops import cuda_build

BIG = 3.4e38


class PlanarCands(NamedTuple):
    """Planar candidate planes, ``(B, N, C)`` f32 each, contiguous."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    mask: torch.Tensor  # f32 0/1


def to_planar(cand) -> PlanarCands:
    """AoS ``CandSet`` (``pts (B, N, C, 3)`` / ``mask (B, N, C)``) -> planar
    planes.  One transpose per capture, amortized over the iterations."""
    return PlanarCands(
        x=cand.pts[..., 0].contiguous(),
        y=cand.pts[..., 1].contiguous(),
        z=cand.pts[..., 2].contiguous(),
        mask=cand.mask.to(torch.float32).contiguous(),
    )


def nn_select_plain(planar: PlanarCands, queries: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of kernel B4: returns ``(tgt (B, N, 3), d2min (B, N))``.

    The arg-min is the explicit first-min formula (lowest candidate index
    among equal distances), not ``torch.argmin``, whose choice among equal
    values is not guaranteed.  The JAX package extracts the winner with a
    one-hot sum; for finite planes that equals this direct read, except that
    the sum turns -0.0 into +0.0, which ``+ 0.0`` reproduces."""
    C = planar.mask.shape[-1]
    dx = planar.x - queries[..., 0:1]
    dy = planar.y - queries[..., 1:2]
    dz = planar.z - queries[..., 2:3]
    d2 = (dx * dx + dy * dy) + dz * dz
    d2 = torch.where(planar.mask > 0, d2, BIG)
    dmin = torch.amin(d2, dim=-1, keepdim=True)
    lane = torch.arange(C, device=d2.device)
    first = torch.amin(torch.where(d2 <= dmin, lane, C), dim=-1, keepdim=True)
    tgt = torch.cat([torch.gather(p, -1, first) for p in (planar.x, planar.y, planar.z)], dim=-1) + 0.0
    return tgt, dmin[..., 0]


def nn_select(planar: PlanarCands, queries: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel B4 (see :func:`nn_select_plain` for the contract).  ``d2min``
    is ``3.4e38`` (not inf) for queries with no candidate; callers threshold
    on it."""
    if not queries.is_cuda:
        return nn_select_plain(planar, queries)
    if queries.dim() != 3 or queries.shape[-1] != 3:
        raise ValueError(f"nn_select kernel: queries must be (B, N, 3), got {tuple(queries.shape)}")
    B, N, _ = queries.shape
    dev = queries.device
    C = planar.mask.shape[-1]
    for name, t in (("queries", queries),) + tuple(zip(PlanarCands._fields, planar)):
        if t.device != dev or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"nn_select kernel: {name} must be contiguous float32 on {dev}")
        if name != "queries" and t.shape != (B, N, C):
            raise ValueError(f"nn_select kernel: plane {name} must be {(B, N, C)}, got {tuple(t.shape)}")
    if C < 1:
        raise ValueError("nn_select kernel: needs at least one candidate per query")
    out = torch.empty((B, N, 4), dtype=torch.float32, device=dev)
    if B * N == 0:
        return out[..., :3], out[..., 3]
    fn = cuda_build.load("match").nn_select_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    err = fn(
        cuda_build.ptr(queries), *(cuda_build.ptr(p) for p in planar), cuda_build.ptr(out),
        B * N, C, cuda_build.stream_ptr(dev),
    )
    cuda_build.check(err, "nn_select_kernel")
    nn_select.launches += 1
    return out[..., :3], out[..., 3]


nn_select.launches = 0
