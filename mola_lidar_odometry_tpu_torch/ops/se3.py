"""SO(3)/SE(3) Lie-group operations on (batched) torch tensors.

Port of ``mola_lidar_odometry_tpu/ops/se3.py``: the same formulas, series
switch-over points and tangent ordering ``[rho(3), phi(3)]``, on float32
tensors with any leading batch shape.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

# Series switch-over point: below this angle use Taylor expansions.
_EPS = 1e-6


class Pose(NamedTuple):
    """An SE(3) element (optionally batched): rotation matrix + translation."""

    R: torch.Tensor  # (..., 3, 3)
    t: torch.Tensor  # (..., 3)

    @staticmethod
    def identity(batch: Tuple[int, ...] = (), device="cuda", dtype=torch.float32) -> "Pose":
        R = torch.eye(3, dtype=dtype, device=device).expand(batch + (3, 3)).clone()
        t = torch.zeros(batch + (3,), dtype=dtype, device=device)
        return Pose(R, t)

    def matrix(self) -> torch.Tensor:
        """Return the (..., 4, 4) homogeneous matrix."""
        batch = self.t.shape[:-1]
        M = torch.zeros(batch + (4, 4), dtype=self.t.dtype, device=self.t.device)
        M[..., :3, :3] = self.R
        M[..., :3, 3] = self.t
        M[..., 3, 3] = 1.0
        return M


def _eye_like(x: torch.Tensor, shape) -> torch.Tensor:
    return torch.eye(3, dtype=x.dtype, device=x.device).expand(shape)


def hat(phi: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator: (..., 3) -> (..., 3, 3) skew-symmetric matrix."""
    x, y, z = phi[..., 0], phi[..., 1], phi[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def vee(M: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`hat`: (..., 3, 3) -> (..., 3)."""
    return torch.stack([M[..., 2, 1], M[..., 0, 2], M[..., 1, 0]], dim=-1)


def _sinc_coeffs(theta2: torch.Tensor):
    """Stable A = sin(t)/t, B = (1-cos(t))/t^2, C = (1-A)/t^2 given t^2."""
    theta = torch.sqrt(torch.clamp(theta2, min=0.0))
    small = theta2 < _EPS
    one = torch.ones_like(theta2)
    safe_t2 = torch.where(small, one, theta2)
    A = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / torch.where(small, one, theta))
    B = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / safe_t2)
    C = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, (1.0 - A) / safe_t2)
    return A, B, C


def _hat_sq(phi: torch.Tensor, theta2: torch.Tensor) -> torch.Tensor:
    """hat(phi)^2 computed analytically as phi phi^T - |phi|^2 I."""
    outer = phi[..., :, None] * phi[..., None, :]
    return outer - theta2[..., None, None] * _eye_like(phi, outer.shape)


def so3_exp(phi: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula: (..., 3) axis-angle -> (..., 3, 3) rotation."""
    theta2 = dot3(phi, phi)  # XLA fuses the squared norm as it fuses a dot
    A, B, _ = _sinc_coeffs(theta2)
    K = hat(phi)
    K2 = _hat_sq(phi, theta2)
    return _eye_like(phi, K.shape) + A[..., None, None] * K + B[..., None, None] * K2


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> axis-angle (..., 3).  Stable near 0 and near pi."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_theta)
    w = vee(R - R.transpose(-1, -2)) * 0.5  # = sin(theta) * axis
    sin_theta = torch.sin(theta)

    near_pi = cos_theta < -1.0 + 1e-5
    small = theta < 1e-4

    scale = torch.where(
        small,
        1.0 + theta * theta / 6.0,
        theta / torch.where(sin_theta == 0, torch.ones_like(sin_theta), sin_theta),
    )
    phi_generic = scale[..., None] * w

    Rp = R + _eye_like(R, R.shape)
    diag = torch.stack([Rp[..., 0, 0], Rp[..., 1, 1], Rp[..., 2, 2]], dim=-1)
    k = torch.argmax(diag, dim=-1)
    col = torch.gather(Rp, -1, k[..., None, None].expand(Rp.shape[:-1] + (1,)))[..., 0]
    axis = col / torch.clamp(torch.linalg.norm(col, dim=-1, keepdim=True), min=1e-12)
    sign = torch.where(torch.sum(axis * w, dim=-1, keepdim=True) < 0, -1.0, 1.0)
    phi_pi = sign * axis * theta[..., None]

    return torch.where(near_pi[..., None], phi_pi, phi_generic)


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` on float32 tensors rounded ONCE to float32, as a fused
    multiply-add does.

    On CUDA tensors this is ``torch.addcmul``, whose kernel evaluates
    ``c + 1 * a * b`` and is compiled with multiply-add contraction: one
    launch, one fused multiply-add (``tests/test_torch_kernels_cuda.py`` and
    ``chip_smoke.py`` hold it against the emulation below).  On the CPU,
    where no torch op fuses, it is emulated exactly: the product of two
    floats is exact in float64, the float64 sum is made round-to-odd (TwoSum
    gives its error, and an inexact even result steps to its neighbour
    towards the error), and a round-to-odd result with 29 spare bits rounds
    to float32 as the exact sum would."""
    if a.is_cuda:
        return torch.addcmul(c, a, b)
    return fma_f32_emulated(a, b, c)


def fma_f32_emulated(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """The exact float64 emulation of :func:`fma_f32`, on any device."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(s.dtype)
    return torch.where((err != 0) & even, torch.nextafter(s, toward), s).float()


def dot3(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Sum over a last axis of length 3 of ``M * v`` as the chain
    ``fma(M2, v2, fma(M1, v1, M0 * v0))``.

    This is how the JAX package's jitted 3-term dots (the rotation of
    points and of poses) round on XLA's CPU code, which fuses them into
    multiply-adds; an eager einsum rounds every product, or fuses them,
    depending on the host's BLAS.  Rounding as XLA does keeps a point on a
    voxel or pairing boundary on the side where the JAX package puts it."""
    acc = M[..., 0] * v[..., 0]
    acc = fma_f32(M[..., 1], v[..., 1], acc)
    return fma_f32(M[..., 2], v[..., 2], acc)


def _matvec(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.einsum("...ij,...j->...i", M, v)


def se3_exp(xi: torch.Tensor) -> Pose:
    """se(3) exp: (..., 6) [rho, phi] -> Pose.  Uses the left Jacobian V."""
    rho, phi = xi[..., :3], xi[..., 3:]
    theta2 = dot3(phi, phi)  # XLA fuses the squared norm as it fuses a dot
    A, B, C = _sinc_coeffs(theta2)
    K = hat(phi)
    K2 = _hat_sq(phi, theta2)
    I = _eye_like(xi, K.shape)
    R = I + A[..., None, None] * K + B[..., None, None] * K2
    V = I + B[..., None, None] * K + C[..., None, None] * K2
    return Pose(R, _matvec(V, rho))


def se3_log(pose: Pose) -> torch.Tensor:
    """SE(3) log: Pose -> (..., 6) [rho, phi]."""
    phi = so3_log(pose.R)
    theta2 = dot3(phi, phi)  # XLA fuses the squared norm as it fuses a dot
    A, B, _ = _sinc_coeffs(theta2)
    K = hat(phi)
    K2 = _hat_sq(phi, theta2)
    I = _eye_like(phi, K.shape)
    small = theta2 < _EPS
    safe_t2 = torch.where(small, torch.ones_like(theta2), theta2)
    coef = torch.where(small, 1.0 / 12.0 + theta2 / 720.0, (1.0 - A / (2.0 * B)) / safe_t2)
    Vinv = I - 0.5 * K + coef[..., None, None] * K2
    return torch.cat([_matvec(Vinv, pose.t), phi], dim=-1)


def compose(a: Pose, b: Pose) -> Pose:
    """a ∘ b (apply b first, then a); both products round as :func:`dot3`."""
    R = dot3(a.R[..., :, None, :], b.R.transpose(-1, -2)[..., None, :, :])
    return Pose(R, dot3(a.R, b.t[..., None, :]) + a.t)


def inverse(p: Pose) -> Pose:
    Rt = p.R.transpose(-1, -2)
    return Pose(Rt, -dot3(Rt, p.t[..., None, :]))


def relative(a: Pose, b: Pose) -> Pose:
    """a^{-1} ∘ b: pose of b expressed in frame a (MRPT's ``b - a``)."""
    return compose(inverse(a), b)


def transform(p: Pose, pts: torch.Tensor) -> torch.Tensor:
    """Apply pose to points: (..., N, 3) -> (..., N, 3), rotated by
    :func:`dot3`, then translated."""
    return dot3(p.R[..., None, :, :], pts[..., None, :]) + p.t[..., None, :]


def pose_error_norms(a: Pose, b: Pose) -> Tuple[torch.Tensor, torch.Tensor]:
    """(translation-norm, rotation-angle) of the relative pose a^{-1} b."""
    rel = relative(a, b)
    return torch.linalg.norm(rel.t, dim=-1), torch.linalg.norm(so3_log(rel.R), dim=-1)


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (..., 4) [qx, qy, qz, qw] (TUM order) -> (..., 3, 3)."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    n = torch.sqrt(x * x + y * y + z * z + w * w)
    x, y, z, w = x / n, y / n, z / n, w / n
    return torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], dim=-1),
            torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], dim=-1),
            torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], dim=-1),
        ],
        dim=-2,
    )


def rot_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> unit quaternion (..., 4) [qx, qy, qz, qw] (TUM order),
    Shepperd's method made branch-free by selecting the largest candidate."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qw0 = torch.stack([m21 - m12, m02 - m20, m10 - m01, 1.0 + tr], dim=-1)
    qx0 = torch.stack([1.0 + m00 - m11 - m22, m01 + m10, m02 + m20, m21 - m12], dim=-1)
    qy0 = torch.stack([m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21, m02 - m20], dim=-1)
    qz0 = torch.stack([m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22, m10 - m01], dim=-1)
    scores = torch.stack(
        [1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22], dim=-1
    )
    best = torch.argmax(scores, dim=-1)
    cands = torch.stack([qw0, qx0, qy0, qz0], dim=-2)  # (..., 4, 4)
    q = torch.gather(cands, -2, best[..., None, None].expand(best.shape + (1, 4)))[..., 0, :]
    q = q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=1e-12)
    return q * torch.where(q[..., 3:4] < 0, -1.0, 1.0)


def ypr_to_rot(yaw: torch.Tensor, pitch: torch.Tensor, roll: torch.Tensor) -> torch.Tensor:
    """MRPT yaw/pitch/roll (Z-Y-X intrinsic) -> rotation matrix."""
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    cp, sp = torch.cos(pitch), torch.sin(pitch)
    cr, sr = torch.cos(roll), torch.sin(roll)
    return torch.stack(
        [
            torch.stack([cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr], dim=-1),
            torch.stack([sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr], dim=-1),
            torch.stack([-sp, cp * sr, cp * cr], dim=-1),
        ],
        dim=-2,
    )


def rot_to_ypr(R: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Rotation matrix -> MRPT yaw/pitch/roll (Z-Y-X intrinsic)."""
    pitch = torch.arcsin(torch.clamp(-R[..., 2, 0], -1.0, 1.0))
    yaw = torch.atan2(R[..., 1, 0], R[..., 0, 0])
    roll = torch.atan2(R[..., 2, 1], R[..., 2, 2])
    return yaw, pitch, roll
