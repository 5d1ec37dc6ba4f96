"""ICP align on the fused path: capture, align, reselect, align.

Port of ``mola_lidar_odometry_tpu/ops/icp.py`` for the configurations that
take the JAX package's fully fused path (``_fused_eligible``): one
point-to-point matcher with one pairing per point, capture-once under the
twist hook, no Horn stage and no Anderson acceleration — the shipped
lidar3d-default hot path.  Each align runs, for the whole fleet at once:

  1. kernel B1 at the entry pose (top-2 per probed voxel; rows kept);
  2. kernel B3 for up to ``_FUSED_REFRESH_AT`` iterations;
  3. kernel B2: re-rank the kept rows against the settled pose;
  4. kernel B3 for the rest of the budget, resuming the iteration count.

The JAX package runs phase 2 under ``lax.cond(need2)``; here it is one
batched launch for every instance, and ``need2`` selects per instance which
result stands.  Any other configuration raises ``NotImplementedError``
(ROADMAP queue A, "generic align loop").
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from mola_lidar_odometry_tpu_torch.ops import pallas_capture, pallas_icp, se3
from mola_lidar_odometry_tpu_torch.ops.se3 import Pose
from mola_lidar_odometry_tpu_torch.ops.solver import PosePrior
from mola_lidar_odometry_tpu_torch.ops.voxel_hash import VoxelHashMap
from mola_lidar_odometry_tpu_torch.utils.expr import Expr


@dataclass(frozen=True)
class MatcherCfg:
    """One matcher entry (Matcher_Points_DistanceThreshold /
    Matcher_Point2Plane x one pointLayerMatches row)."""

    kind: str = "point2point"  # or "point2plane"
    local_layer: str = "decimated_for_icp"
    global_layer: str = "localmap"
    threshold: Expr = field(default_factory=lambda: Expr("2.0*ADAPTIVE_THRESHOLD_SIGMA"))
    threshold_angular_deg: float = 0.0
    pairings_per_point: int = 1
    weight: float = 1.0
    run_from_iteration: int = 0
    run_up_to_iteration: int = 0  # 0 = unbounded
    allow_match_already_matched: bool = True
    search_radius: float = 0.8
    min_plane_points: int = 6
    plane_eigen_threshold: float = 1e-2


@dataclass(frozen=True)
class HornCfg:
    """Closed-form Horn stage ahead of GN (Solver_Horn)."""

    run_until_translation_correction_smaller_than: float = 5e-4


@dataclass(frozen=True)
class IcpConfig:
    """Static ICP configuration compiled from a pipeline YAML block.

    The JAX package's ``use_pallas`` and ``per_voxel_nn`` switches have no
    counterpart: the port always runs their ``True`` setting (the fused
    path), on the CUDA kernels for CUDA tensors and on their plain twins
    for CPU tensors."""

    max_iterations: int = 300
    min_abs_step_trans: float = 1e-4
    min_abs_step_rot: float = 5e-5
    matchers: Tuple[MatcherCfg, ...] = (MatcherCfg(),)
    kernel_param: Expr = field(default_factory=lambda: Expr("0.5*ADAPTIVE_THRESHOLD_SIGMA"))
    gn_inner_iterations: int = 2
    horn: Optional[HornCfg] = None
    nn_neighbors: int = 8
    anderson_m: int = 0
    hook_min_trans: float = 0.0
    hook_min_rot: float = 0.0


class IcpResult(NamedTuple):
    pose: Pose  # (B, 3, 3), (B, 3)
    quality: torch.Tensor  # (B,) f32 in [0, 1]
    iterations: torch.Tensor  # (B,) i32 — iterations consumed by this align()
    hook_stop: torch.Tensor  # (B,) bool — stopped by the twist-reopt hook
    converged: torch.Tensor  # (B,) bool


def _fused_eligible(cfg: IcpConfig) -> bool:
    """Static eligibility of the fully fused align (as the JAX package)."""
    if len(cfg.matchers) != 1 or cfg.anderson_m >= 2 or cfg.horn is not None:
        return False
    mc = cfg.matchers[0]
    return (
        mc.kind == "point2point"
        and mc.pairings_per_point == 1
        and mc.run_from_iteration == 0
        and mc.run_up_to_iteration == 0
        and mc.allow_match_already_matched
        and mc.threshold_angular_deg == 0.0
    )


# After this many iterations one candidate refresh (by reselect) makes the
# top-2 per-voxel view effectively exact for the remaining iterations.
_FUSED_REFRESH_AT = 8


def _table(expr: Expr, env: Dict[str, object], B: int, maxit: int, device) -> torch.Tensor:
    """Evaluate a per-iteration expression into a (B, maxit) f32 table."""
    env_vec = {k: v[:, None] if torch.is_tensor(v) and v.dim() == 1 else v for k, v in env.items()}
    env_vec["ICP_ITERATION"] = torch.arange(maxit, dtype=torch.float32, device=device)[None, :]
    val = torch.as_tensor(expr(env_vec), dtype=torch.float32, device=device)
    return val.expand(B, maxit).contiguous()


def _align_fused_call(cfg, maps, layers, init_pose: Pose, prior: PosePrior, env, budget) -> IcpResult:
    mc = cfg.matchers[0]
    xyz, valid = layers[mc.local_layer]
    m0 = maps[mc.global_layer]
    B, dev = xyz.shape[0], xyz.device
    maxit = cfg.max_iterations
    thr_tab = _table(mc.threshold, env, B, maxit, dev)
    kc_tab = _table(cfg.kernel_param, env, B, maxit, dev)
    nbr = cfg.nn_neighbors
    kw = dict(
        min_abs_step_trans=cfg.min_abs_step_trans, min_abs_step_rot=cfg.min_abs_step_rot,
        hook_min_trans=cfg.hook_min_trans, hook_min_rot=cfg.hook_min_rot, weight=mc.weight,
        gn_inner=cfg.gn_inner_iterations, hook_ref_R=init_pose.R, hook_ref_t=init_pose.t,
    )
    prior_args = (prior.mean.R, prior.mean.t, prior.info, thr_tab, kc_tab)

    q0 = se3.transform(init_pose, xyz)
    cx0, cy0, cz0, cm0, rows0 = pallas_capture.capture_planar(
        m0.data, m0.voxel_size, m0.epoch, q0, nbr, K=m0.K, stride=m0.stride, valid=valid,
        return_rows=True,
    )
    zero = torch.zeros((B,), dtype=torch.int32, device=dev)
    b1 = torch.clamp(budget, max=_FUSED_REFRESH_AT)
    R1, t1, it1, hook1, conv1, q1 = pallas_icp.align_fused(
        (cx0, cy0, cz0, cm0), xyz, valid, init_pose.R, init_pose.t, *prior_args, b1, it0=zero, **kw
    )
    if cfg.max_iterations <= _FUSED_REFRESH_AT:  # static single phase
        return IcpResult(Pose(R1, t1), q1, it1, hook1, conv1)

    cs1 = pallas_capture.capture_planar_reselect(
        rows0, m0.voxel_size, m0.epoch, se3.transform(Pose(R1, t1), xyz), q0, nbr,
        K=m0.K, stride=m0.stride, valid=valid,
    )
    R2, t2, it2, hook2, conv2, q2 = pallas_icp.align_fused(
        cs1, xyz, valid, R1, t1, *prior_args, budget - it1, it0=it1, **kw
    )
    need2 = ~hook1 & (budget > it1)

    def pick(a, b):
        return torch.where(need2.view((-1,) + (1,) * (a.dim() - 1)), a, b)

    return IcpResult(
        pose=Pose(pick(R2, R1), pick(t2, t1)),
        quality=pick(q2, q1),
        iterations=pick(it1 + it2, it1),
        hook_stop=pick(hook2, hook1),
        converged=pick(conv2, conv1),
    )


def align(
    maps: Dict[str, VoxelHashMap],
    layers: Dict[str, Tuple[torch.Tensor, torch.Tensor]],  # name -> (xyz (B,N,3), valid (B,N))
    init_pose: Pose,
    prior: PosePrior,
    cfg: IcpConfig,
    env: Dict[str, object],
    max_iterations=None,  # (B,) remaining-budget override
) -> IcpResult:
    """Run the fused matcher->solver loop from ``init_pose`` for every
    instance until convergence, budget exhaustion or a hook stop."""
    mc0 = cfg.matchers[0]
    xyz = layers[mc0.local_layer][0]
    B, dev = xyz.shape[0], xyz.device
    if max_iterations is None:
        max_iterations = cfg.max_iterations
    budget = torch.as_tensor(max_iterations, dtype=torch.int32, device=dev).expand(B).contiguous()
    hook_on = cfg.hook_min_trans > 0 or cfg.hook_min_rot > 0
    m0 = maps.get(mc0.global_layer)
    fused = (
        hook_on
        and cfg.horn is None
        and _fused_eligible(cfg)
        and isinstance(m0, VoxelHashMap)
        and m0.points_per_voxel > 2
        and m0.stride <= 128
        and 2 * cfg.nn_neighbors <= 64
        and xyz.shape[1] <= 16384
    )
    if not fused:
        raise NotImplementedError(
            "ICP configuration outside the fused path: ROADMAP queue A, 'generic align loop'"
        )
    return _align_fused_call(cfg, maps, layers, init_pose, prior, env, budget)
