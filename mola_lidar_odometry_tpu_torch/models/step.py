"""The per-scan odometry step over a fleet of instances.

Port of ``mola_lidar_odometry_tpu/models/step.py``: ``step(carry, scan) ->
(carry, out)`` where every field of ``carry`` and ``scan`` has a leading
fleet dimension B.  The stages are the JAX package's (reference
LidarOdometry.cpp:627-1314):

  1. min_time_between_scans drop
  2. sensor-range init / IIR update
  3. dynamic-variable environment
  4. 'raw' layer + timestamp adjust
  5. filter pass 1 (decimate/range/bbox) + 2 (deskew)
  6. observation validity check
  7. motion-model prior from navstate
  8. first-scan seed | ICP + twist re-optimization loop
  9. quality gate -> fuse | reset
 10. adaptive sigma
 11. keyframe deciders + ring pruning
 12. bad-first-ICP map restart
 13. local-map insert + rolling-slab prune

The JAX step is vmapped, so its ``lax.cond``s run both branches and select
per instance; the port computes both and selects with masks, which gives
the same results (first-scan seed vs ICP, and the rollback of inactive
frames).  The map tables are excluded from that rollback: their updates are
already masked, and the insert and prune update them in place.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, NamedTuple, Tuple

import torch

from mola_lidar_odometry_tpu_torch.models import keyframes, navstate as ns
from mola_lidar_odometry_tpu_torch.models.filter_graph import apply_pipeline, deskew_ops
from mola_lidar_odometry_tpu_torch.models.spec import OdometrySpec
from mola_lidar_odometry_tpu_torch.ops import icp as icp_ops, maps as maps_ops, se3
from mola_lidar_odometry_tpu_torch.ops.pointcloud import PointCloud, on_device
from mola_lidar_odometry_tpu_torch.ops.se3 import Pose
from mola_lidar_odometry_tpu_torch.ops.solver import PosePrior
from mola_lidar_odometry_tpu_torch.ops.voxel_hash import InsertStats
from mola_lidar_odometry_tpu_torch.parallel import point_axis as pa

_TWIST_VARS = ("vx", "vy", "vz", "wx", "wy", "wz")


class Scan(NamedTuple):
    """A batch of padded LiDAR frames in sensor coordinates."""

    xyz: torch.Tensor  # (B, N, 3) f32
    time: torch.Tensor  # (B, N) f32 per-point stamp (relative)
    intensity: torch.Tensor  # (B, N) f32
    ring: torch.Tensor  # (B, N) i32
    valid: torch.Tensor  # (B, N) bool
    stamp: torch.Tensor  # (B,) f32 scan timestamp


class Carry(NamedTuple):
    """All persistent odometry state of the fleet (leading dimension B)."""

    pose_R: torch.Tensor  # (B, 3, 3) last accepted lidar pose
    pose_t: torch.Tensor  # (B, 3)
    last_time: torch.Tensor  # (B,) f32 stamp of the last processed scan (-inf: none)
    first_time: torch.Tensor  # (B,) f32
    frame_idx: torch.Tensor  # (B,) i32
    traj_len: torch.Tensor  # (B,) i32
    sigma: torch.Tensor  # (B,) f32 adaptive threshold (0 = uninitialized)
    last_icp_quality: torch.Tensor  # (B,) f32
    last_icp_iters: torch.Tensor  # (B,) f32
    twist_corr_count: torch.Tensor  # (B,) f32
    est_range: torch.Tensor  # (B,) f32 (0 = unset)
    inst_range: torch.Tensor  # (B,) f32 (0 = unset)
    nav: ns.NavStateBuffer
    maps: Dict[str, Any]  # layer name -> VoxelHashMap, NdtMap or OccupancyMap
    lm_kfs: keyframes.PoseRing
    sm_kfs: keyframes.PoseRing
    removal_counter: torch.Tensor  # (B,) i32
    last_twist: torch.Tensor  # (B, 6)
    has_twist: torch.Tensor  # (B,) bool
    map_has_content: torch.Tensor  # (B,) bool
    mapping_enabled: torch.Tensor  # (B,) bool


class StepOutput(NamedTuple):
    """Per-scan results of every instance, (B, ...) each."""

    pose_R: torch.Tensor
    pose_t: torch.Tensor
    stamp: torch.Tensor
    quality: torch.Tensor
    sigma: torch.Tensor
    iterations: torch.Tensor  # i32 total ICP iterations
    twist: torch.Tensor  # (B, 6)
    processed: torch.Tensor
    accepted: torch.Tensor
    kf_local: torch.Tensor
    kf_simplemap: torch.Tensor
    sm_insert: torch.Tensor
    map_restarted: torch.Tensor
    est_range: torch.Tensor
    n_raw: torch.Tensor
    n_icp_layer: torch.Tensor
    n_map_layer: torch.Tensor
    corrections: torch.Tensor
    map_collision_drops: torch.Tensor
    map_full_drops: torch.Tensor
    deferred_drops: torch.Tensor


def select(mask: torch.Tensor, a, b):
    """Per-instance ``where(mask, a, b)`` over nested NamedTuples, dicts and
    tensors with a leading fleet dimension (static ints pass through)."""
    if torch.is_tensor(a):
        return torch.where(mask.view((-1,) + (1,) * (a.dim() - 1)), a, b)
    if isinstance(a, dict):
        return {k: select(mask, a[k], b[k]) for k in a}
    if isinstance(a, tuple):
        items = [select(mask, x, y) for x, y in zip(a, b)]
        return type(a)(*items) if hasattr(a, "_fields") else tuple(items)
    return a


def init_carry(spec: OdometrySpec, batch: int, device="cuda") -> Carry:
    B = batch

    def full(v, dtype=torch.float32):
        return torch.full((B,), v, dtype=dtype, device=device)

    p0 = spec.initial_localization.fixed_initial_pose
    R0 = torch.eye(3, device=device).expand(B, 3, 3).clone()
    t0 = torch.zeros((B, 3), device=device)
    if spec.initial_localization.enabled and any(abs(v) > 0 for v in p0):
        R0 = se3.ypr_to_rot(full(p0[3]), full(p0[4]), full(p0[5]))
        t0 = torch.tensor(p0[:3], dtype=torch.float32, device=device).expand(B, 3).clone()
    return Carry(
        pose_R=R0,
        pose_t=t0,
        last_time=full(-math.inf),
        first_time=full(0.0),
        frame_idx=full(0, torch.int32),
        traj_len=full(0, torch.int32),
        sigma=full(0.0),
        last_icp_quality=full(1.0),
        last_icp_iters=full(0.0),
        twist_corr_count=full(0.0),
        est_range=full(0.0),
        inst_range=full(0.0),
        nav=ns.NavStateBuffer.empty(B, device),
        maps={d.name: d.create(1.0, B, device) for d in spec.map_layers},
        lm_kfs=keyframes.PoseRing.empty(spec.kf_ring_capacity, B, device),
        sm_kfs=keyframes.PoseRing.empty(spec.kf_ring_capacity, B, device),
        removal_counter=full(0, torch.int32),
        last_twist=torch.zeros((B, 6), device=device),
        has_twist=full(False, torch.bool),
        map_has_content=full(False, torch.bool),
        mapping_enabled=full(True, torch.bool),
    )


def _dynamic_env(spec: OdometrySpec, c: Carry, stamp) -> Dict[str, torch.Tensor]:
    """updatePipelineDynamicVariables (reference LidarOdometry.cpp:1581-1635)."""
    tw = torch.where(c.has_twist[:, None], c.last_twist, 0.0)
    yaw, pitch, roll = se3.rot_to_ypr(c.pose_R)
    zero = torch.zeros_like(c.sigma)
    env = {k: tw[:, i] for i, k in enumerate(_TWIST_VARS)}
    env.update(
        robot_x=c.pose_t[:, 0], robot_y=c.pose_t[:, 1], robot_z=c.pose_t[:, 2],
        robot_yaw=yaw, robot_pitch=pitch, robot_roll=roll,
        ADAPTIVE_THRESHOLD_SIGMA=torch.where(c.sigma != 0, c.sigma, spec.adaptive_threshold.initial_sigma),
        ICP_ITERATION=zero,
        icp_iterations=c.last_icp_iters,
        SENSOR_TIME_OFFSET=zero,
        twistCorrectionCount=c.twist_corr_count,
        ESTIMATED_SENSOR_MAX_RANGE=c.est_range,
        INSTANTANEOUS_SENSOR_MAX_RANGE=torch.where(c.inst_range > 0, c.inst_range, 20.0),
        current_relative_timestamp=stamp - c.first_time,
    )
    return env


def _model_error(rel: Pose, max_range) -> torch.Tensor:
    """computeModelError (reference LidarOdometry.cpp:1440-1448)."""
    theta = torch.linalg.norm(se3.so3_log(rel.R), dim=-1)
    return torch.linalg.norm(rel.t, dim=-1) + 2.0 * max_range * torch.sin(theta / 2.0)


def _as_batch(v, like: torch.Tensor) -> torch.Tensor:
    return on_device(v, torch.float32, like.device).expand(like.shape[0])


def _count(pc: PointCloud, axis) -> torch.Tensor:
    """(B,) valid points of a layer; a slice's counts are summed over the
    point axis."""
    n = pc.count()
    return pa.all_sum(n, axis) if isinstance(pc, pa.PointSlice) else n


def _radius(pc: PointCloud, axis) -> torch.Tensor:
    """(B,) bounding radius of a layer; a slice's is the max over the point
    axis."""
    r = pc.bounding_radius()
    return pa.all_max(r, axis) if isinstance(pc, pa.PointSlice) else r


def filter_scan(
    spec: OdometrySpec, c: Carry, scan: Scan, axis=None
) -> Tuple[Carry, Dict[str, torch.Tensor], Dict[str, PointCloud]]:
    """Stages 2-5 of the step: the carry with its start time and, on the
    first frame, the sensor range (the raw bounding radius); the dynamic
    variables; and the scan's layers after the generator, timestamp and
    filter pipelines, ``"raw"`` among them.  Under a point axis ``scan``
    holds this rank's slice of every scan's points, and the layers that
    still hold slices after the pipelines are ``PointSlice``s."""
    first_time = torch.where(c.frame_idx == 0, scan.stamp, c.first_time)
    raw_cls = PointCloud if axis is None else pa.PointSlice
    raw_pc = raw_cls(scan.xyz, scan.time, scan.intensity, scan.ring, scan.valid)
    raw_radius = torch.clamp(_radius(raw_pc, axis), min=spec.absolute_minimum_sensor_range)
    c1 = c._replace(est_range=torch.where(c.est_range > 0, c.est_range, raw_radius), first_time=first_time)
    env = _dynamic_env(spec, c1, scan.stamp)
    layers: Dict[str, PointCloud] = {"raw": raw_pc}
    for pipe in (spec.generator_pipeline, spec.adjust_pipeline, spec.filter1, spec.filter2):
        layers = apply_pipeline(pipe, layers, env, axis)
    return c1, env, layers


def make_step(spec: OdometrySpec, axis=None) -> Callable[[Carry, Scan], Tuple[Carry, StepOutput]]:
    """Compile the spec into the fleet scan-step function.  With a
    ``PointAxis`` (``parallel/point_axis.py``) the step takes this rank's
    slice of every scan's points and keeps the carry the same on every rank
    of the point group: the counts and radii of slices are all-reduced,
    the ICP and map layers are whole (gathered where they are still
    slices), and the ICP sums its normal equations over the group."""
    dsk_ops = deskew_ops(spec.filter2)

    def redeskew(layers, twist):
        env = {k: twist[:, i] for i, k in enumerate(_TWIST_VARS)}
        layers = dict(layers)
        for op in dsk_ops:
            op(layers, env)
        return layers

    def run_icp_with_corrections(c: Carry, layers, nav_est: ns.NavStateEstimate, env, dt_scan):
        """ICP incl. the twist re-optimization restarts (reference
        LidarOdometry.cpp:916-1024)."""
        cfg, cfg_nomm = spec.icp_with_vel, spec.icp_without_vel
        v3 = nav_est.valid[:, None]
        init_pose = Pose(
            torch.where(v3[..., None], nav_est.pose.R, c.pose_R), torch.where(v3, nav_est.pose.t, c.pose_t)
        )
        prior = nav_est.prior
        if spec.pin_se2:
            pin = torch.diag(on_device([0, 0, 1e6, 1e6, 1e6, 0], torch.float32, c.pose_t.device))
            prior = PosePrior(mean=Pose(init_pose.R, init_pose.t), info=prior.info + pin)
        last_kf_pose = Pose(c.pose_R, c.pose_t)
        matcher_layers = sorted({mc.local_layer for cc in (cfg, cfg_nomm) for mc in cc.matchers})

        def align_once(pose, layers_, budget):
            whole = {name: pa.gather_cloud(layers_[name], axis) for name in matcher_layers}
            icp_layers = {name: (pc.xyz, pc.valid) for name, pc in whole.items()}
            res_w = icp_ops.align(c.maps, icp_layers, pose, prior, cfg, env, budget, axis=axis)
            if cfg_nomm is cfg:
                return res_w
            B = pose.t.shape[0]
            res_n = icp_ops.align(
                c.maps, icp_layers, pose, PosePrior.none(B, pose.t.device), cfg_nomm, env, budget, axis=axis
            )
            return select(nav_est.valid, res_w, res_n)

        maxit = torch.full_like(c.frame_idx, cfg.max_iterations)
        if not (spec.optimize_twist and dsk_ops):
            res = align_once(init_pose, layers, maxit)
            return res.pose, res.quality, res.iterations, torch.zeros_like(res.iterations), layers, init_pose

        max_corr = spec.optimize_twist_max_corrections
        vary_names = sorted({op.output for op in dsk_ops})

        def with_vary(vary):
            merged = dict(layers)
            merged.update(vary)
            return merged

        def correction_state(res, twist, remaining, corr):
            new_remaining = torch.clamp(remaining - res.iterations, min=0)
            can = res.hook_stop & (corr < max_corr) & (dt_scan > 0) & (new_remaining > 0)
            rel = se3.relative(last_kf_pose, res.pose)
            tw_new = torch.cat([rel.t, se3.so3_log(rel.R)], dim=-1) / torch.clamp(dt_scan, min=1e-6)[:, None]
            return new_remaining, can, torch.where(can[:, None], tw_new, twist)

        res0 = align_once(init_pose, layers, maxit)
        rem, pending, twist = correction_state(res0, nav_est.twist, maxit, torch.zeros_like(maxit))
        pose, corr, quality, iters = res0.pose, pending.to(torch.int32), res0.quality, res0.iterations
        vary = {k: layers[k] for k in vary_names}
        # One host sync per correction round (the ``any``): the JAX package's
        # batched while_loop runs until no instance is pending; rounds are
        # rare (a hook stop), and removing the sync belongs to a later
        # CUDA-graph change.  Under a point axis every rank takes the same
        # branch (the ``any`` is all-reduced).
        while bool(pa.all_any(pending.any(), axis)):
            redeskewed = redeskew(with_vary(vary), twist)
            vary2 = {k: redeskewed[k] for k in vary_names}
            res = align_once(pose, with_vary(vary2), rem)
            rem2, can, twist2 = correction_state(res, twist, rem, corr)
            new = (res.pose, twist2, rem2, corr + can.to(torch.int32), vary2, res.quality, can, iters + res.iterations)
            old = (pose, twist, rem, corr, vary, quality, pending, iters)
            pose, twist, rem, corr, vary, quality, pending, iters = select(pending, new, old)
        return pose, quality, iters, corr, with_vary(vary), init_pose

    def step(c: Carry, scan: Scan) -> Tuple[Carry, StepOutput]:
        stamp = scan.stamp
        B, dev = stamp.shape[0], stamp.device
        drop = (stamp - c.last_time) < spec.min_time_between_scans  # 1. masked whole-step skip
        first_ever = c.frame_idx == 0
        c1, env, layers = filter_scan(spec, c, scan, axis)  # 2-5
        first_time, est_range0, raw_pc = c1.first_time, c1.est_range, layers["raw"]

        # 2b. sensor range IIR update (ICP-layer radius)
        rng_layer = layers.get(spec.icp_local_layer, layers["raw"])
        inst = torch.clamp(_radius(rng_layer, axis), min=spec.absolute_minimum_sensor_range)
        a = spec.max_sensor_range_filter_coefficient
        est_range = torch.where(first_ever, est_range0, a * est_range0 + (1 - a) * inst)

        # 6. observation validity
        ov = spec.observation_validity
        if ov.enabled:
            obs_valid = _count(layers.get(ov.check_layer_name, raw_pc), axis) > ov.minimum_point_count
        else:
            obs_valid = torch.ones_like(drop)
        active = obs_valid & ~drop

        # 7. motion model
        nav0 = c.nav
        if spec.initial_localization.enabled:
            p0 = Pose(c.pose_R, c.pose_t)
            seeded = ns.fuse_pose(ns.fuse_pose(ns.NavStateBuffer.empty(B, dev), stamp - 0.2, p0), stamp - 0.1, p0)
            nav0 = select(first_ever, seeded, nav0)
        nav_est = ns.estimate(nav0, spec.navstate, stamp)
        dt_scan = torch.where(torch.isfinite(c.last_time), stamp - c.last_time, 0.0)
        map_empty = ~c.map_has_content

        # 8. first-scan seed | ICP: both computed, selected per instance
        icp = run_icp_with_corrections(c1._replace(est_range=est_range), layers, nav_est, env, dt_scan)
        seed_pose = Pose(c.pose_R, c.pose_t)
        zero_i = torch.zeros_like(c.frame_idx)
        first = (seed_pose, torch.ones_like(stamp), zero_i, zero_i, layers, seed_pose)
        pose, quality, iters, corrections, layers_f, init_guess = select(map_empty, first, icp)

        # 9. gate
        accepted = quality >= spec.min_icp_goodness
        new_pose = select(accepted, pose, seed_pose)
        nav1 = select(accepted, ns.fuse_pose(nav0, stamp, new_pose), ns.NavStateBuffer.empty(B, dev))
        traj_len = c.traj_len + accepted.to(torch.int32)

        # 10. adaptive sigma
        at = spec.adaptive_threshold
        if at.enabled:
            model_err = _model_error(se3.relative(init_guess, pose), est_range)
            rot_err = torch.where(
                nav_est.valid, 0.1 * torch.linalg.norm(nav_est.twist[:, 3:], dim=-1) * est_range, 0.0
            )
            gain = torch.clamp(at.kp * (1.0 - quality), 0.1, at.kp)
            sig0 = torch.where(c.sigma != 0, c.sigma, at.initial_sigma)
            sigma_upd = torch.clamp(
                at.alpha * sig0 + (1 - at.alpha) * ((model_err + rot_err) * gain), at.min_motion, at.maximum_sigma
            )
            sigma = torch.where(map_empty, c.sigma, sigma_upd)
        else:
            sigma = c.sigma

        # 11. keyframe deciders
        lmu = spec.local_map_updates
        is_first_lm, d_lm, r_lm = keyframes.check(c.lm_kfs, new_pose, from_last_only=lmu.measure_from_last_kf_only)
        env_kf = dict(env)
        env_kf["ESTIMATED_SENSOR_MAX_RANGE"] = est_range
        min_t = _as_batch(lmu.min_translation_between_keyframes(env_kf), stamp)
        min_r = _as_batch(lmu.min_rotation_between_keyframes_deg(env_kf), stamp) * (math.pi / 180.0)
        kf_due = accepted & lmu.enabled & nav_est.valid & (is_first_lm | (d_lm > min_t) | (r_lm > min_r))
        update_local_map = (map_empty | kf_due) & c.mapping_enabled
        lm_kfs = select(update_local_map & ~map_empty, keyframes.insert(c.lm_kfs, new_pose), c.lm_kfs)
        max_keep = _as_batch(lmu.max_distance_to_keep_keyframes(env_kf), stamp)
        do_prune_kfs = update_local_map & (max_keep > 0) & (c.removal_counter >= lmu.check_for_removal_every_n)
        lm_kfs = select(do_prune_kfs, keyframes.remove_farther_than(lm_kfs, new_pose.t, max_keep), lm_kfs)
        removal_counter = torch.where(
            do_prune_kfs, 0, c.removal_counter + update_local_map.to(torch.int32)
        ).to(torch.int32)

        smc = spec.simplemap
        is_first_sm, d_sm, r_sm = keyframes.check(c.sm_kfs, new_pose, from_last_only=smc.measure_from_last_kf_only)
        min_t_sm = _as_batch(smc.min_translation_between_keyframes(env_kf), stamp)
        min_r_sm = _as_batch(smc.min_rotation_between_keyframes_deg(env_kf), stamp) * (math.pi / 180.0)
        distance_enough_sm = map_empty | is_first_sm | (d_sm > min_t_sm) | (r_sm > min_r_sm)
        update_simplemap = accepted & (distance_enough_sm | smc.add_non_keyframes_too) & smc.generate
        sm_kfs = select(
            update_simplemap & distance_enough_sm & ~map_empty, keyframes.insert(c.sm_kfs, new_pose), c.sm_kfs
        )

        # 12. bad-first-ICP restart
        restart = ~accepted & (c.traj_len == 1) & active
        traj_len = torch.where(restart, 0, traj_len).to(torch.int32)
        update_local_map = update_local_map & ~restart & active

        # 13. local-map update: masked inserts, then the rolling-slab prune
        layer_defs = {d.name: d for d in spec.map_layers}
        maps_post: Dict[str, Any] = {}
        for name, d in layer_defs.items():
            m0 = c.maps[name]
            vs = torch.where(map_empty & active, _as_batch(d.voxel_size(env_kf), stamp), m0.voxel_size)
            maps_post[name] = maps_ops.clear_where(maps_ops.set_voxel_size(m0, vs), restart)
        ins_stats = InsertStats.zero(B, dev)
        for op in spec.map_inserts:
            insert_pc = pa.gather_cloud(layers_f.get(op.input_layer, layers_f[spec.icp_local_layer]), axis)
            insert_global = insert_pc._replace(
                xyz=se3.transform(new_pose, insert_pc.xyz), valid=insert_pc.valid & update_local_map[:, None]
            )
            maps_post[op.target_map_layer], st = maps_ops.insert_stats(
                maps_post[op.target_map_layer], insert_global, new_pose.t, layer_defs[op.target_map_layer]
            )
            ins_stats = ins_stats + st
        for name, d in layer_defs.items():
            maps_post[name] = maps_ops.prune_farther_than_amortized(
                maps_post[name], new_pose.t, d.remove_voxels_farther_than(env_kf), c.frame_idx
            )

        icp_layer_pc = layers_f.get(spec.icp_local_layer, raw_pc)
        map_layer_pc = layers_f.get(spec.map_inserts[0].input_layer, icp_layer_pc) if spec.map_inserts else icp_layer_pc
        sm_first = map_empty & smc.generate
        i32 = torch.int32
        out = StepOutput(
            pose_R=new_pose.R, pose_t=new_pose.t, stamp=stamp, quality=quality, sigma=sigma,
            iterations=iters.to(i32), twist=nav_est.twist, processed=obs_valid,
            accepted=accepted & obs_valid, kf_local=update_local_map & obs_valid,
            kf_simplemap=(update_simplemap & distance_enough_sm) | sm_first,
            sm_insert=update_simplemap | sm_first, map_restarted=restart, est_range=est_range,
            n_raw=_count(raw_pc, axis).to(i32), n_icp_layer=_count(icp_layer_pc, axis).to(i32),
            n_map_layer=_count(map_layer_pc, axis).to(i32), corrections=corrections.to(i32),
            map_collision_drops=ins_stats.collision_drops, map_full_drops=ins_stats.full_drops,
            deferred_drops=ins_stats.deferred_drops,
        )
        new_carry = Carry(
            pose_R=new_pose.R, pose_t=new_pose.t, last_time=stamp, first_time=first_time,
            frame_idx=c.frame_idx + 1, traj_len=traj_len, sigma=sigma, last_icp_quality=quality,
            last_icp_iters=iters.to(torch.float32), twist_corr_count=corrections.to(torch.float32),
            est_range=est_range, inst_range=inst, nav=nav1, maps=maps_post, lm_kfs=lm_kfs,
            sm_kfs=sm_kfs, removal_counter=removal_counter, last_twist=nav_est.twist,
            has_twist=nav_est.valid, map_has_content=(c.map_has_content | update_local_map) & ~restart,
            mapping_enabled=c.mapping_enabled,
        )
        # inactive frame: keep all state but the (already masked) maps
        guarded = select(active, new_carry._replace(maps={}), c._replace(first_time=first_time, maps={}))
        new_carry = guarded._replace(maps=maps_post)
        zb, zi = torch.zeros_like(drop), torch.zeros_like(c.frame_idx)
        drop_out = StepOutput(
            pose_R=c.pose_R, pose_t=c.pose_t, stamp=stamp, quality=torch.zeros_like(stamp),
            sigma=c.sigma, iterations=zi, twist=c.last_twist, processed=zb, accepted=zb,
            kf_local=zb, kf_simplemap=zb, sm_insert=zb, map_restarted=zb, est_range=c.est_range,
            n_raw=zi, n_icp_layer=zi, n_map_layer=zi, corrections=zi, map_collision_drops=zi,
            map_full_drops=zi, deferred_drops=zi,
        )
        return new_carry, select(~drop, out, drop_out)

    return step
