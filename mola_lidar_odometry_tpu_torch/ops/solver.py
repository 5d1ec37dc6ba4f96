"""Robust SE(3) alignment solvers: Gauss-Newton over pairing blocks and
Horn's closed form, batched over the fleet.

Port of ``mola_lidar_odometry_tpu/ops/solver.py`` (``PosePrior``, the
Geman-McClure weight, ``PairingBlock``, ``gauss_newton_step_blocks``,
``solve_gauss_newton_blocks``, the single pairing-set ``gauss_newton_step``
and ``solve_gauss_newton``, ``solve_horn``).  The fused align kernel (B3)
carries its own Gauss-Newton loop; these serve the generic align loop.  The
normal equations are one batched einsum over all (padded) pairings and the
6x6 system goes to ``torch.linalg.solve_ex``, which, unlike
``torch.linalg.solve``, does not read its singularity flag back on the host.

Tangent ordering everywhere: [rho(3) translation, phi(3) rotation], with
left-multiplicative updates ``T <- exp(eps) T``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from mola_lidar_odometry_tpu_torch.ops import se3
from mola_lidar_odometry_tpu_torch.ops.pointcloud import on_device
from mola_lidar_odometry_tpu_torch.ops.se3 import Pose
from mola_lidar_odometry_tpu_torch.parallel.point_axis import all_sum


class PosePrior(NamedTuple):
    """Gaussian prior on the solved pose: mean + 6x6 information (tangent)."""

    mean: Pose  # (B, 3, 3), (B, 3)
    info: torch.Tensor  # (B, 6, 6) f32; zeros = no prior

    @staticmethod
    def none(batch: int, device="cuda") -> "PosePrior":
        return PosePrior(
            Pose.identity((batch,), device=device),
            torch.zeros((batch, 6, 6), dtype=torch.float32, device=device),
        )


def geman_mcclure_weight(r2: torch.Tensor, c) -> torch.Tensor:
    """IRLS weight of the Geman-McClure kernel with scale ``c``:
    rho(r) = r^2 / (r^2 + c^2)  =>  w(r) = (c^2 / (r^2 + c^2))^2."""
    c2 = c * c
    t = c2 / (r2 + c2)
    return t * t


class PairingBlock(NamedTuple):
    """One matcher's pairings for the solver.

    ``kind`` is static: "p2p" (3-dim residual ``Tp - q``) or "p2pl" (scalar
    residual ``n . (Tp - q)``, normals in ``nrm``).  ``weight`` is the
    matcher's layer weight (pointLayerMatches ``weight`` field).
    """

    kind: str
    p_local: torch.Tensor  # (B, N, 3)
    q_global: torch.Tensor  # (B, N, 3)
    nrm: torch.Tensor  # (B, N, 3); zeros for p2p
    valid: torch.Tensor  # (B, N) bool
    weight: float


def _per_instance(v, like: torch.Tensor) -> torch.Tensor:
    """A scalar or (B,) value as a (B, 1) f32 column beside ``like`` (B, N)."""
    return on_device(v, torch.float32, like.device).expand(like.shape[0])[:, None]


def _block_normal_equations(pose: Pose, blk: PairingBlock, kernel_c):
    """H (B, 6, 6) and b (B, 6) of one pairing block at ``pose``."""
    tp = se3.transform(pose, blk.p_local)  # (B, N, 3)
    eye = torch.eye(3, dtype=torch.float32, device=tp.device).expand(tp.shape[:-1] + (3, 3))
    J3 = torch.cat([eye, -se3.hat(tp)], dim=-1)  # (B, N, 3, 6) d(Tp)/d eps
    c = _per_instance(kernel_c, blk.valid)
    if blk.kind == "p2p":
        r = tp - blk.q_global
        w = geman_mcclure_weight(torch.sum(r * r, dim=-1), c) * blk.valid * blk.weight
        Jw = J3 * w[..., None, None]
        H = torch.einsum("bnij,bnik->bjk", Jw, J3)
        b = torch.einsum("bnij,bni->bj", Jw, r)
    elif blk.kind == "p2pl":
        r = torch.sum(blk.nrm * (tp - blk.q_global), dim=-1)  # (B, N)
        J = torch.einsum("bni,bnij->bnj", blk.nrm, J3)  # (B, N, 6)
        w = geman_mcclure_weight(r * r, c) * blk.valid * blk.weight
        Jw = J * w[..., None]
        H = torch.einsum("bni,bnj->bij", Jw, J)
        b = torch.einsum("bni,bn->bi", Jw, r)
    else:
        raise ValueError(blk.kind)
    return H, b


def _trace(M: torch.Tensor) -> torch.Tensor:
    return torch.diagonal(M, dim1=-2, dim2=-1).sum(-1)


def gauss_newton_step_blocks(
    pose: Pose, blocks: Sequence[PairingBlock], kernel_c, prior: PosePrior, damping: float = 1e-8, axis=None
) -> Tuple[Pose, torch.Tensor]:
    """One robust GN update over heterogeneous pairing blocks + prior;
    returns (new pose, tangent increment (B, 6)).  An instance with no valid
    pairing and no prior does not move (a mask, no host branch).  Under a
    point axis (``parallel/point_axis.py``) the blocks hold this rank's
    pairings: H, b and the pairing flag are summed over the group in one
    all-reduce before the prior and the solve, so every rank solves the
    same system."""
    B, dev = pose.t.shape[0], pose.t.device
    H = torch.zeros((B, 6, 6), dtype=torch.float32, device=dev)
    b = torch.zeros((B, 6), dtype=torch.float32, device=dev)
    any_pair = torch.zeros((B,), dtype=torch.bool, device=dev)
    for blk in blocks:
        Hb, bb = _block_normal_equations(pose, blk, kernel_c)
        H, b = H + Hb, b + bb
        any_pair = any_pair | torch.any(blk.valid, dim=-1)
    if axis is not None:
        red = all_sum(torch.cat([H.reshape(B, 36), b, any_pair.to(torch.float32)[:, None]], dim=1), axis)
        H, b, any_pair = red[:, :36].reshape(B, 6, 6), red[:, 36:42], red[:, 42] > 0

    rp = se3.se3_log(se3.relative(prior.mean, pose))
    H = H + prior.info
    b = b + torch.einsum("bij,bj->bi", prior.info, rp)

    scale = _trace(H) / 6.0 + 1.0
    Hd = H + (damping * scale)[:, None, None] * torch.eye(6, dtype=torch.float32, device=dev)
    eps = -torch.linalg.solve_ex(Hd, b[..., None]).result[..., 0]
    ok = any_pair | (_trace(prior.info) > 0)
    eps = torch.where(ok[:, None], eps, 0.0)
    return se3.compose(se3.se3_exp(eps), pose), eps


def solve_gauss_newton_blocks(
    pose: Pose, blocks: Sequence[PairingBlock], kernel_c, prior: PosePrior, inner_iterations: int = 2, axis=None
) -> Tuple[Pose, torch.Tensor]:
    """The solver's inner loop over fixed pairings (Solver_GaussNewton
    ``maxIterations``)."""
    total = torch.zeros((pose.t.shape[0], 6), dtype=torch.float32, device=pose.t.device)
    for _ in range(inner_iterations):
        pose, eps = gauss_newton_step_blocks(pose, blocks, kernel_c, prior, axis=axis)
        total = total + eps
    return pose, total


def gauss_newton_step(
    pose: Pose,
    p_local: torch.Tensor,  # (B, N, 3) local points (vehicle frame)
    q_global: torch.Tensor,  # (B, N, 3) paired map points
    pair_valid: torch.Tensor,  # (B, N) bool
    kernel_c,
    prior: PosePrior,
    damping: float = 1e-8,
) -> Tuple[Pose, torch.Tensor]:
    """One Gauss-Newton update over one set of point-to-point pairings:
    the block step over a single block of weight 1, the same arithmetic;
    returns (new pose, tangent increment (B, 6))."""
    blk = PairingBlock("p2p", p_local, q_global, torch.zeros_like(p_local), pair_valid, 1.0)
    return gauss_newton_step_blocks(pose, [blk], kernel_c, prior, damping)


def solve_gauss_newton(
    pose: Pose,
    p_local: torch.Tensor,
    q_global: torch.Tensor,
    pair_valid: torch.Tensor,
    kernel_c,
    prior: PosePrior,
    inner_iterations: int = 2,
) -> Tuple[Pose, torch.Tensor]:
    """The solver's inner loop over one fixed set of pairings
    (Solver_GaussNewton ``maxIterations``); returns (pose, total tangent
    increment)."""
    total = torch.zeros((pose.t.shape[0], 6), dtype=torch.float32, device=pose.t.device)
    for _ in range(inner_iterations):
        pose, eps = gauss_newton_step(pose, p_local, q_global, pair_valid, kernel_c, prior)
        total = total + eps
    return pose, total


def _det3(M: torch.Tensor) -> torch.Tensor:
    return (
        M[..., 0, 0] * (M[..., 1, 1] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 1])
        - M[..., 0, 1] * (M[..., 1, 0] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 0])
        + M[..., 0, 2] * (M[..., 1, 0] * M[..., 2, 1] - M[..., 1, 1] * M[..., 2, 0])
    )


def solve_horn(
    p_local: torch.Tensor,  # (B, N, 3)
    q_global: torch.Tensor,  # (B, N, 3)
    pair_valid: torch.Tensor,  # (B, N) bool
    weights: Optional[torch.Tensor] = None,
    axis=None,
) -> Pose:
    """Closed-form weighted rigid alignment (Horn / Kabsch via SVD): the T
    minimizing sum w |T p - q|^2 per instance — the coarse stage of
    ``Solver_Horn``.  Fewer than 3 pairs give the identity.  Under a point
    axis the pairs are this rank's: the weight sums and centroid sums, then
    the cross-covariance and the pair count, are summed over the group."""
    w = pair_valid.to(torch.float32)
    if weights is not None:
        w = w * weights
    sums = all_sum(torch.cat([torch.sum(w, dim=-1, keepdim=True), torch.sum(w[..., None] * p_local, dim=1),
                              torch.sum(w[..., None] * q_global, dim=1)], dim=1), axis)
    wsum = torch.clamp(sums[:, :1], min=1e-9)
    pc = sums[:, 1:4] / wsum
    qc = sums[:, 4:7] / wsum
    P = (p_local - pc[:, None, :]) * w[..., None]
    Q = q_global - qc[:, None, :]
    C = torch.einsum("bni,bnj->bij", P, Q)  # (B, 3, 3) cross-covariance
    n_pairs = torch.sum(pair_valid, dim=-1).to(torch.float32)
    if axis is not None:
        red = all_sum(torch.cat([C.reshape(-1, 9), n_pairs[:, None]], dim=1), axis)
        C, n_pairs = red[:, :9].reshape(-1, 3, 3), red[:, 9]
    U, _, Vt = torch.linalg.svd(C)
    V, Ut = Vt.transpose(-1, -2), U.transpose(-1, -2)
    d = torch.sign(_det3(torch.matmul(V, Ut)))
    D = torch.diag_embed(torch.stack([torch.ones_like(d), torch.ones_like(d), d], dim=-1))
    R = torch.matmul(torch.matmul(V, D), Ut)
    t = qc - torch.einsum("bij,bj->bi", R, pc)
    ok = n_pairs >= 3
    eye = torch.eye(3, dtype=torch.float32, device=R.device).expand_as(R)
    return Pose(torch.where(ok[:, None, None], R, eye), torch.where(ok[:, None], t, 0.0))
