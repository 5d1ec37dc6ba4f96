"""Closed-form linear algebra on small symmetric matrices, shared by the NDT
map's plane fit (``ops/ndt.py``) and the point map's (``ops/voxel_hash.py``).

Port of the JAX package's ``ops/ndt.py::_sym_eigen_smallest``."""

from __future__ import annotations

import math
from typing import Tuple

import torch

from mola_lidar_odometry_tpu_torch.ops import se3
from mola_lidar_odometry_tpu_torch.ops.pointcloud import on_device


def sym_eigen_smallest(cov6: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Closed-form smallest eigenpair of symmetric 3x3 batches.

    ``cov6`` is (..., 6) packed [xx, yy, zz, xy, xz, yz].  Returns
    ``(eigvec_min (..., 3), eig_min (...), eig_mid (...))`` by the
    trigonometric eigenvalue formula and a column of
    ``(A - e1 I)(A - e2 I)`` as the eigenvector.  The 3x3 product is
    written as elementwise products (``se3.dot3``), not a batched GEMM, so
    no TF32 or library rounding enters it."""
    xx, yy, zz, xy, xz, yz = cov6.unbind(-1)
    # XLA multiplies by a constant's reciprocal and fuses the squares into
    # multiply-adds; the port rounds these first steps as it does
    third = on_device(1.0 / 3.0, torch.float32, cov6.device)
    q = (xx + yy + zz) * third
    p1 = xy * xy + xz * xz + yz * yz
    a, b, c = xx - q, yy - q, zz - q
    p2 = se3.fma_f32(c, c, se3.fma_f32(a, a, b * b)) + 2.0 * p1
    p = torch.sqrt(torch.clamp(p2 * on_device(1.0 / 6.0, torch.float32, cov6.device), min=1e-30))

    bxx, byy, bzz = (xx - q) / p, (yy - q) / p, (zz - q) / p
    bxy, bxz, byz = xy / p, xz / p, yz / p
    detB = bxx * (byy * bzz - byz * byz) - bxy * (bxy * bzz - byz * bxz) + bxz * (bxy * byz - byy * bxz)
    r = torch.clamp(detB / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) * third
    e1 = q + 2.0 * p * torch.cos(phi)  # largest
    e3 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)  # smallest
    e2 = 3.0 * q - e1 - e3

    def shifted(e):
        return torch.stack(
            [torch.stack([xx - e, xy, xz], -1), torch.stack([xy, yy - e, yz], -1), torch.stack([xz, yz, zz - e], -1)],
            -2,
        )

    A1, A2 = shifted(e1), shifted(e2)
    M = se3.dot3(A1[..., :, None, :], A2.transpose(-1, -2)[..., None, :, :])  # (..., 3, 3) = A1 @ A2
    norms = torch.linalg.norm(M, dim=-2)  # column norms (..., 3)
    col = torch.argmax(norms, dim=-1)  # the first largest, as jnp.argmax
    v = torch.gather(M, -1, col[..., None, None].expand(M.shape[:-1] + (1,)))[..., 0]
    vn = torch.linalg.norm(v, dim=-1, keepdim=True)
    v = v / torch.clamp(vn, min=1e-20)
    # isotropic covariance: +z (the eigen-ratio gate rejects it anyway)
    degen = vn[..., 0] < 1e-12
    v = torch.where(degen[..., None], on_device([0.0, 0.0, 1.0], torch.float32, v.device), v)
    return v, e3, e2
