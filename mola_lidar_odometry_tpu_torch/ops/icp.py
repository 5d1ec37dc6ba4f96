"""The ICP align: the fused path and the generic matcher->solver loop.

Port of ``mola_lidar_odometry_tpu/ops/icp.py``.  Configurations that take
the JAX package's fully fused path (``_fused_eligible``: one point-to-point
matcher with one pairing per point, capture-once under the twist hook, no
Horn stage and no Anderson acceleration — the shipped lidar3d-default hot
path), with ``fused_align`` and ``per_voxel_nn`` on, run for the whole
fleet at once (``_align_fused_call``):

  1. the capture at the entry pose (top-2 per probed voxel);
  2. kernel B3 for up to ``_FUSED_REFRESH_AT`` iterations;
  3. the refresh at the settled pose;
  4. kernel B3 for the rest of the budget, resuming the iteration count.

The capture is kernel B1 (its bucket rows kept) when ``capture_kernel`` is
on and the map's slot fits one 128-lane row (stride <= 128: up to 126
points per voxel); the refresh then re-ranks those rows on kernel B2.
Otherwise (deeper voxels, or ``capture_kernel`` off) the capture is the
plain per-voxel capture (``voxel_hash.capture``), whose candidates B3 takes
after one transpose (``pallas_icp.candset_planes``), and the refresh is a
fresh capture at the settled pose over ``refresh_neighbors`` probes (4
when phase 1 probes 8).  ``phase1_neighbors``, ``refresh_reselect``,
``refresh_neighbors`` and ``fused_refresh`` are the JAX package's A/B
switches of this path.  The JAX package runs phase 2 under
``lax.cond(need2)``; here it is one batched launch for every instance, and
``need2`` selects per instance which result stands.

Every other configuration (several matchers, ``runFromIteration`` /
``runUpToIteration``, ``thresholdAngularDeg``, two pairings per point,
one-to-one pairing, a Horn stage, Anderson acceleration, no hook, and
``fused_align`` or ``per_voxel_nn`` off) runs the generic loop of the JAX
package's ``align``: per iteration, every matcher pairs its local layer
against its cached (or, without the hook, re-captured) candidates, the
block Gauss-Newton solver (or Horn while coarse) updates the pose, and the
exits are tested.  The JAX loop is a ``lax.while_loop`` under ``vmap``: the
body runs while any instance is live and each instance's state freezes when
its own condition turns false.  Here the state carries the fleet dimension,
``live`` is a ``(B,)`` mask that selects new or old state, and the loop's
exit test ``live.any()`` is one host sync per iteration.  Every
single-pairing point-to-point matcher on a point map matches through kernel
B4 (``pallas_match.nn_select``) on planar candidates; NDT layers pair with
their voxel means and planes (``ops/ndt.py``).

``IcpConfig.per_voxel_nn`` selects the capture, as in the JAX package: on
(the default, the JAX package's TPU setting) each probed voxel reduces to
its two points nearest the query and the fused path is open; off (the JAX
package's setting on every other backend) every point of each probed voxel
is a candidate (``C = P*K``), the fused path is barred, and the generic
loop selects over all of them on kernel B4.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

from mola_lidar_odometry_tpu_torch.ops import maps as maps_ops, pallas_capture, pallas_icp, pallas_match, se3
from mola_lidar_odometry_tpu_torch.ops.filters import voxel_coords, voxel_hash
from mola_lidar_odometry_tpu_torch.ops.pointcloud import on_device
from mola_lidar_odometry_tpu_torch.ops.se3 import Pose
from mola_lidar_odometry_tpu_torch.ops.solver import (
    PairingBlock,
    PosePrior,
    solve_gauss_newton_blocks,
    solve_horn,
)
from mola_lidar_odometry_tpu_torch.ops.voxel_hash import CandSet, VoxelHashMap
from mola_lidar_odometry_tpu_torch.parallel import point_axis as pa
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

    The JAX package reads its ICP switches from ``MOLA_TPU_*`` variables;
    here they are fields, and the defaults are its TPU setting:

    * ``per_voxel_nn`` (``MOLA_TPU_PER_VOXEL_NN``): on, single-pairing
      point-to-point matchers capture the per-voxel top-2 view and eligible
      configurations take the fused path; off, they capture every point of
      each probed voxel and every configuration takes the generic loop;
    * ``fused_align`` (``use_pallas``, ``MOLA_TPU_PALLAS``): off, an
      eligible configuration takes the generic loop over the per-voxel view
      (capture-once under the hook).  The JAX package then selects in XLA;
      the port selects on kernel B4 (its plain twin for CPU tensors), which
      computes the same;
    * ``capture_kernel`` (``MOLA_TPU_PALLAS_CAPTURE``): off, the fused path
      captures with the plain per-voxel capture instead of kernel B1, as it
      does anyway for maps whose slot is wider than 128 lanes;
    * ``phase1_neighbors`` (``MOLA_TPU_PHASE1_NEIGHBORS``): the probes of
      the fused path's first capture, at most ``nn_neighbors`` (None: all);
    * ``refresh_reselect`` (``MOLA_TPU_REFRESH_RESELECT``): the refresh
      re-ranks kernel B1's rows on kernel B2; off (or without B1's rows), a
      fresh capture at the settled pose;
    * ``refresh_neighbors`` (``MOLA_TPU_REFRESH_NEIGHBORS``): the probes of
      a fresh refresh, at most ``nn_neighbors`` (None: 4 when phase 1 probes
      8, else phase 1's);
    * ``fused_refresh`` (``MOLA_TPU_FUSED_REFRESH``): off, the fused path
      runs one phase, as it does when ``max_iterations`` ends at the
      refresh point."""

    max_iterations: int = 300
    min_abs_step_trans: float = 1e-4
    min_abs_step_rot: float = 5e-5
    matchers: Tuple[MatcherCfg, ...] = (MatcherCfg(),)
    kernel_param: Expr = field(default_factory=lambda: Expr("0.5*ADAPTIVE_THRESHOLD_SIGMA"))
    gn_inner_iterations: int = 2
    horn: Optional[HornCfg] = None
    nn_neighbors: int = 8
    per_voxel_nn: bool = True
    anderson_m: int = 0
    hook_min_trans: float = 0.0
    hook_min_rot: float = 0.0
    fused_align: bool = True
    capture_kernel: bool = True
    phase1_neighbors: Optional[int] = None
    refresh_reselect: bool = True
    refresh_neighbors: Optional[int] = None
    fused_refresh: bool = True


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


# After this many iterations one candidate refresh makes the top-2
# per-voxel view effectively exact for the remaining iterations.
_FUSED_REFRESH_AT = 8


def _table(expr: Expr, env: Dict[str, object], B: int, maxit: int, device) -> torch.Tensor:
    """Evaluate a per-iteration expression into a (B, maxit) f32 table."""
    env_vec = {k: v[:, None] if torch.is_tensor(v) and v.dim() == 1 else v for k, v in env.items()}
    env_vec["ICP_ITERATION"] = torch.arange(maxit, dtype=torch.float32, device=device)[None, :]
    val = on_device(expr(env_vec), torch.float32, device)
    return val.expand(B, maxit).contiguous()


def _align_fused_call(cfg, maps, layers, init_pose: Pose, prior: PosePrior, env, budget) -> IcpResult:
    mc = cfg.matchers[0]
    xyz, valid = layers[mc.local_layer]
    xyz = xyz.contiguous()  # kernel B3 reads the points in place; a decimation's output is a strided view
    m0 = maps[mc.global_layer]
    B, dev = xyz.shape[0], xyz.device
    maxit = cfg.max_iterations
    thr_tab = _table(mc.threshold, env, B, maxit, dev)
    kc_tab = _table(cfg.kernel_param, env, B, maxit, dev)
    kw = dict(
        min_abs_step_trans=cfg.min_abs_step_trans, min_abs_step_rot=cfg.min_abs_step_rot,
        hook_min_trans=cfg.hook_min_trans, hook_min_rot=cfg.hook_min_rot, weight=mc.weight,
        gn_inner=cfg.gn_inner_iterations, hook_ref_R=init_pose.R, hook_ref_t=init_pose.t,
    )
    prior_args = (prior.mean.R, prior.mean.t, prior.info, thr_tab, kc_tab)
    # kernel B1 selects within one 128-lane row: W = 128 // stride ways
    planar_capture = cfg.capture_kernel and m0.stride <= 128
    nbr1 = cfg.nn_neighbors if cfg.phase1_neighbors is None else min(cfg.nn_neighbors, cfg.phase1_neighbors)
    two_phase = cfg.max_iterations > _FUSED_REFRESH_AT and cfg.fused_refresh
    reselect = planar_capture and cfg.refresh_reselect

    def capture_at(q, nbr, return_rows=False):
        if planar_capture:
            return pallas_capture.capture_planar(
                m0.data, m0.voxel_size, m0.epoch, q, nbr, K=m0.K, stride=m0.stride, valid=valid,
                return_rows=return_rows,
            )
        return maps_ops.capture(m0, q, nbr, True)

    q0 = se3.transform(init_pose, xyz)
    cs0 = capture_at(q0, nbr1, return_rows=reselect and two_phase)
    if reselect and two_phase:
        cs0, rows0 = cs0[:4], cs0[4]
    zero = torch.zeros((B,), dtype=torch.int32, device=dev)
    b1 = torch.clamp(budget, max=_FUSED_REFRESH_AT)
    R1, t1, it1, hook1, conv1, q1 = pallas_icp.align_fused(
        cs0, xyz, valid, init_pose.R, init_pose.t, *prior_args, b1, it0=zero, **kw
    )
    if not two_phase:  # a budget that ends at the refresh point, or the refresh switched off
        return IcpResult(Pose(R1, t1), q1, it1, hook1, conv1)

    qs = se3.transform(Pose(R1, t1), xyz)
    if reselect:
        cs1 = pallas_capture.capture_planar_reselect(
            rows0, m0.voxel_size, m0.epoch, qs, q0, nbr1, K=m0.K, stride=m0.stride, valid=valid,
        )
    else:
        # a fresh capture at the settled pose, over the 4-probe footprint
        # when phase 1 probed 8 (the JAX package's device A/B: within the
        # hook bound of the answer and under the annealed threshold)
        default = 4 if nbr1 == 8 else nbr1
        nbr2 = min(cfg.nn_neighbors, default if cfg.refresh_neighbors is None else cfg.refresh_neighbors)
        cs1 = capture_at(qs, nbr2)
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


def _capture_all(cfg: IcpConfig, maps, layers, pose: Pose) -> Tuple[Any, ...]:
    """One neighbourhood capture per matcher at ``pose``.  Single-pairing
    point-to-point matchers on point maps capture the per-voxel top-2 view
    under ``per_voxel_nn`` (every point of each probed voxel without it)
    and go planar for kernel B4; two pairings per point and point-to-plane
    need the full per-voxel sets; NDT layers capture their voxel means."""
    sets = []
    for mc in cfg.matchers:
        xyz, _ = layers[mc.local_layer]
        q = se3.transform(pose, xyz)
        single = mc.kind == "point2point" and mc.pairings_per_point == 1
        cs = maps_ops.capture(maps[mc.global_layer], q, cfg.nn_neighbors, cfg.per_voxel_nn and single)
        planar = single and isinstance(cs, CandSet)
        sets.append(pallas_match.to_planar(cs) if planar else cs)
    return tuple(sets)


def _one_to_one(tgt: torch.Tensor, d2: torch.Tensor, pv: torch.Tensor, axis=None) -> torch.Tensor:
    """``allowMatchAlreadyMatchedGlobalPoints: false``: keep at most one
    pairing per global point — the lowest-index local claimant wins.

    Global-point identity comes from quantized coordinates (1 mm cells)
    hashed into a 65536-entry claim table per instance (one flat table,
    keys offset by ``b * table``); ``scatter_reduce_(amin)`` is
    deterministic.  A hash collision can drop a legitimate pair, as in the
    JAX package.  The claim is over every query, so under a point axis the
    ranks' pairings are gathered and each rank keeps its own rows."""
    if axis is not None:
        keep = _one_to_one(pa.gather_points(tgt, axis), None, pa.gather_points(pv, axis))
        return pa.own_rows(keep, axis)
    table = 1 << 16
    B, n = pv.shape
    dev = tgt.device
    cell = torch.full((), 1e-3, dtype=torch.float32, device=dev)
    key = voxel_hash(voxel_coords(tgt, cell), table).to(torch.int64)
    key = key + torch.arange(B, device=dev)[:, None] * table
    idx = torch.arange(n, dtype=torch.int32, device=dev).expand(B, n)
    claim = torch.full((B * table,), n, dtype=torch.int32, device=dev)
    claim.scatter_reduce_(0, key.reshape(-1), torch.where(pv, idx, n).reshape(-1), "amin")
    return pv & (claim[key] == idx)


def _matcher_blocks(
    cfg: IcpConfig, candsets, layers, pose: Pose, env_it: Dict[str, object], it: torch.Tensor, axis=None
) -> Tuple[List[PairingBlock], torch.Tensor, torch.Tensor]:
    """Match every matcher's candidates at ``pose`` (``it`` is the (B,)
    iteration count); returns (blocks, paired (B,), n_local (B,)), the
    counts of this rank's rows under a point axis."""
    B, dev = it.shape[0], it.device
    blocks: List[PairingBlock] = []
    paired = torch.zeros((B,), dtype=torch.float32, device=dev)
    n_local = torch.zeros((B,), dtype=torch.float32, device=dev)
    for mc, cand in zip(cfg.matchers, candsets):
        xyz, valid = layers[mc.local_layer]
        thr = on_device(mc.threshold(env_it), torch.float32, dev).expand(B)[:, None]
        if mc.threshold_angular_deg > 0:
            # the threshold grows with the local point's sensor range
            thr = thr + torch.linalg.norm(xyz, dim=-1) * math.sin(math.radians(mc.threshold_angular_deg))
        active = it >= mc.run_from_iteration
        if mc.run_up_to_iteration > 0:
            active = active & (it <= mc.run_up_to_iteration)
        active = active[:, None]
        q = se3.transform(pose, xyz)
        if mc.kind == "point2plane":
            tgt, nrm, d2, found = maps_ops.match_p2pl(
                cand, q, valid, search_radius=mc.search_radius, min_plane_points=mc.min_plane_points,
                plane_eigen_threshold=mc.plane_eigen_threshold,
            )
            pv = found & (d2 < thr * thr) & active
            blocks.append(PairingBlock("p2pl", xyz, tgt, nrm, pv, mc.weight))
        elif mc.pairings_per_point >= 2:
            tgt2, d22, found2 = maps_ops.match_p2p2(cand, q, valid)
            pv2 = found2 & (d22 < (thr * thr)[..., None]) & active[..., None]
            z = torch.zeros_like(xyz)
            blocks.append(PairingBlock("p2p", xyz, tgt2[:, :, 0], z, pv2[:, :, 0], mc.weight))
            blocks.append(PairingBlock("p2p", xyz, tgt2[:, :, 1], z, pv2[:, :, 1], mc.weight))
            pv = pv2[:, :, 0]
        else:
            tgt, d2, found = maps_ops.match_p2p(cand, q, valid)
            pv = found & (d2 < thr * thr) & active
            if not mc.allow_match_already_matched:
                pv = _one_to_one(tgt, d2, pv, axis)
            blocks.append(PairingBlock("p2p", xyz, tgt, torch.zeros_like(xyz), pv, mc.weight))
        paired = paired + torch.sum(pv, dim=-1).to(torch.float32)
        n_local = n_local + torch.sum(valid, dim=-1).to(torch.float32)
    return blocks, paired, n_local


def _select(mask: torch.Tensor, new, old):
    """Per-instance ``where(mask, new, old)`` over a flat tuple of tensors
    and Poses with a leading fleet dimension."""
    out = []
    for a, b in zip(new, old):
        if isinstance(a, Pose):
            out.append(Pose(*_select(mask, a, b)))
        else:
            out.append(torch.where(mask.view((-1,) + (1,) * (a.dim() - 1)), a, b))
    return tuple(out)


def _anderson(cfg: IcpConfig, init_pose: Pose, pose: Pose, new_pose: Pose, horn_active, X, Fh, hlen):
    """Anderson acceleration in the tangent space at ``init_pose`` (AA-ICP):
    x = log(init^-1 pose), f = G(x) - x; extrapolate x+ = sum_i a_i (X_i +
    F_i) with sum a = 1 minimizing |F a|, under the JAX package's
    safeguards.  Returns (pose, X, Fh, hlen)."""
    m = cfg.anderson_m
    dev = pose.t.device
    x_cur = se3.se3_log(se3.relative(init_pose, pose))
    x_new = se3.se3_log(se3.relative(init_pose, new_pose))
    f_cur = x_new - x_cur
    X2 = torch.cat([X[:, 1:], x_cur[:, None]], dim=1)  # history, newest last
    F2 = torch.cat([Fh[:, 1:], f_cur[:, None]], dim=1)
    hlen2 = torch.clamp(hlen + 1, max=m)
    hmask = (torch.arange(m, device=dev)[None, :] >= (m - hlen2)[:, None]).to(torch.float32)  # (B, m)
    Fm = F2 * hmask[..., None]
    eye = torch.eye(m, dtype=torch.float32, device=dev)
    M = torch.matmul(Fm, Fm.transpose(-1, -2))
    tr = torch.diagonal(M, dim1=-2, dim2=-1).sum(-1)
    M = M + (1e-10 * tr)[:, None, None] * eye + 1e-12 * eye
    # unused history slots are pinned to a = 0 by a huge diagonal
    dead = 1.0 - hmask
    M = M + dead[:, :, None] * dead[:, None, :] * 1e12 * eye
    Minv_1 = torch.linalg.solve_ex(M, hmask[..., None]).result[..., 0]
    denom = torch.sum(hmask * Minv_1, dim=-1, keepdim=True)
    alpha = Minv_1 / torch.where(torch.abs(denom) > 1e-12, denom, 1.0)
    x_aa = torch.sum(alpha[..., None] * (X2 + F2) * hmask[..., None], dim=1)
    aa_pose = se3.compose(init_pose, se3.se3_exp(x_aa))
    fn = torch.linalg.norm(f_cur, dim=-1)
    ok = (
        (hlen2 >= 2)
        & torch.all(torch.isfinite(x_aa), dim=-1)
        & (torch.amax(torch.abs(alpha * hmask), dim=-1) <= 2.0)
        & (fn <= torch.linalg.norm(Fh[:, -1], dim=-1) * 1.5 + 1e-6)
        & (torch.linalg.norm(x_aa - x_new, dim=-1) <= 3.0 * fn)
        & ~horn_active
    )
    (out,) = _select(ok, (aa_pose,), (new_pose,))
    return out, X2, F2, hlen2


def _align_generic(cfg: IcpConfig, maps, layers, init_pose: Pose, prior: PosePrior, env, budget,
                   axis=None) -> IcpResult:
    """The generic matcher->solver loop (see the module docstring).  Under a
    point axis (``parallel/point_axis.py``) each rank captures and pairs its
    own rows of every matcher's (whole) layer; the solvers sum their normal
    equations over the group, the quality its counts, and the loop's exit
    test is all-reduced, so every rank runs as many iterations and holds
    the same pose."""
    B, dev = budget.shape[0], budget.device
    if axis is not None:
        layers = {name: (pa.own_rows(xyz, axis), pa.own_rows(valid, axis)) for name, (xyz, valid) in layers.items()}
    hook_on = cfg.hook_min_trans > 0 or cfg.hook_min_rot > 0
    m_aa = cfg.anderson_m
    # Capture-once: the twist hook bounds the in-align correction far below
    # the probe margin, so the entry-pose candidates serve the whole align.
    # Without the hook (or with a Horn stage) every iteration re-captures.
    cache_ok = hook_on and cfg.horn is None
    candsets0 = _capture_all(cfg, maps, layers, init_pose)

    def get_candsets(pose):
        return candsets0 if cache_ok else _capture_all(cfg, maps, layers, pose)

    def env_at(it):
        env_it = dict(env)
        env_it["ICP_ITERATION"] = it.to(torch.float32)
        return env_it

    def solver_update(pose, it, horn_active):
        """One matcher + solver pass: the fixed-point map G(pose)."""
        env_it = env_at(it)
        blocks, _, _ = _matcher_blocks(cfg, get_candsets(pose), layers, pose, env_it, it, axis)
        gn_pose, _ = solve_gauss_newton_blocks(
            pose, blocks, cfg.kernel_param(env_it), prior, cfg.gn_inner_iterations, axis=axis
        )
        p2p = [b for b in blocks if b.kind == "p2p"]
        if cfg.horn is None or not p2p:  # Horn needs point-to-point pairings
            return gn_pose, (horn_active if cfg.horn is None else torch.zeros_like(horn_active))
        horn_pose = solve_horn(
            torch.cat([b.p_local for b in p2p], dim=1),
            torch.cat([b.q_global for b in p2p], dim=1),
            torch.cat([b.valid for b in p2p], dim=1),
            axis=axis,
        )
        (new_pose,) = _select(horn_active, (horn_pose,), (gn_pose,))
        horn_step = torch.linalg.norm(horn_pose.t - pose.t, dim=-1)
        horn_active = horn_active & (horn_step >= cfg.horn.run_until_translation_correction_smaller_than)
        return new_pose, horn_active

    def body(state):
        pose, it, _, _, horn_active, X, Fh, hlen = state
        new_pose, horn_active = solver_update(pose, it, horn_active)
        if m_aa >= 2:
            new_pose, X, Fh, hlen = _anderson(cfg, init_pose, pose, new_pose, horn_active, X, Fh, hlen)
        dt, dr = se3.pose_error_norms(pose, new_pose)
        converged = (dt < cfg.min_abs_step_trans) & (dr < cfg.min_abs_step_rot)
        if hook_on:
            ht, hr = se3.pose_error_norms(init_pose, new_pose)
            hook = (ht > cfg.hook_min_trans) | (hr > cfg.hook_min_rot)
        else:
            hook = torch.zeros_like(converged)
        return new_pose, it + 1, converged, hook, horn_active, X, Fh, hlen

    m_hist = max(m_aa, 1)
    false = torch.zeros((B,), dtype=torch.bool, device=dev)
    state = (
        init_pose,
        torch.zeros((B,), dtype=torch.int32, device=dev),
        false,
        false,
        torch.full((B,), cfg.horn is not None, dtype=torch.bool, device=dev),
        torch.zeros((B, m_hist, 6), dtype=torch.float32, device=dev),
        torch.zeros((B, m_hist, 6), dtype=torch.float32, device=dev),
        torch.zeros((B,), dtype=torch.int32, device=dev),
    )
    while True:
        live = ~state[2] & ~state[3] & (state[1] < budget)
        if not bool(pa.all_any(live.any(), axis)):  # the loop's one host sync per iteration
            break
        state = _select(live, body(state), state)
    pose, it, converged, hook = state[:4]

    # quality: paired ratio at the final pose and threshold
    _, paired, n_local = _matcher_blocks(cfg, get_candsets(pose), layers, pose, env_at(it), it, axis)
    counts = pa.all_sum(torch.stack([paired, n_local]), axis)
    quality = counts[0] / torch.clamp(counts[1], min=1.0)
    return IcpResult(pose=pose, quality=quality, iterations=it, hook_stop=hook, converged=converged)


def align(
    maps: Dict[str, Any],  # name -> map-layer state (VoxelHashMap, NdtMap)
    layers: Dict[str, Tuple[torch.Tensor, torch.Tensor]],  # name -> (xyz (B,N,3), valid (B,N))
    init_pose: Pose,
    prior: PosePrior,
    cfg: IcpConfig,
    env: Dict[str, object],
    max_iterations=None,  # (B,) remaining-budget override
    axis=None,  # a parallel.point_axis.PointAxis: the layers are whole, the same on every rank
) -> IcpResult:
    """Run the matcher->solver loop from ``init_pose`` for every instance
    until convergence, budget exhaustion or a hook stop: the fused path
    where the configuration allows it (``fused_align`` and
    ``per_voxel_nn`` among its conditions, as in the JAX package), else the
    generic loop.  Under a point axis the fused path's kernels run on every
    rank on the whole layers (their results are the one-device results),
    and the generic loop splits each layer's rows over the ranks."""
    mc0 = cfg.matchers[0]
    xyz = layers[mc0.local_layer][0]
    B, dev = xyz.shape[0], xyz.device
    if max_iterations is None:
        max_iterations = cfg.max_iterations
    budget = on_device(max_iterations, torch.int32, dev).expand(B).contiguous()
    hook_on = cfg.hook_min_trans > 0 or cfg.hook_min_rot > 0
    m0 = maps.get(mc0.global_layer)
    fused = (
        hook_on
        and cfg.fused_align
        and cfg.per_voxel_nn
        and cfg.horn is None
        and _fused_eligible(cfg)
        and isinstance(m0, VoxelHashMap)
        and m0.points_per_voxel > 2
        and 2 * cfg.nn_neighbors <= 64
        and xyz.shape[1] <= 16384
    )
    if fused:
        return _align_fused_call(cfg, maps, layers, init_pose, prior, env, budget)
    return _align_generic(cfg, maps, layers, init_pose, prior, env, budget, axis)
