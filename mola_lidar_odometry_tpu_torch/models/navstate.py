"""Constant-velocity kinematic state fuser (sliding window), batched.

Port of ``mola_lidar_odometry_tpu/models/navstate.py`` (the
``mola::NavStateFuse`` contract): a fixed ring of the last ``WINDOW`` fused
(time, pose) entries per instance; the body twist is the recency-weighted
window solve together with the ``initial_twist`` prior; the ICP prior's
information shrinks with the extrapolation horizon.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Tuple

import torch

from mola_lidar_odometry_tpu_torch.ops import se3
from mola_lidar_odometry_tpu_torch.ops.se3 import Pose
from mola_lidar_odometry_tpu_torch.ops.solver import PosePrior

WINDOW = 8  # ring capacity (entries, not seconds)


@dataclass(frozen=True)
class NavStateConfig:
    max_time_to_use_velocity_model: float = 0.75  # [s]
    sliding_window_length: float = 0.5  # [s]
    sigma_random_walk_acceleration_linear: float = 1.0  # [m/s^2]
    sigma_random_walk_acceleration_angular: float = 10.0  # [rad/s^2]
    sigma_integrator_position: float = 1.0  # [m]
    sigma_integrator_orientation: float = 1.0  # [rad]
    initial_twist: Tuple[float, ...] = (0.0, 0.0, 0.0, 0.0, 0.0, 0.0)
    initial_twist_sigma_lin: float = 20.0  # [m/s]
    initial_twist_sigma_ang: float = 3.0  # [rad/s]
    robust_param: float = 0.0
    max_rmse: float = 0.0

    @staticmethod
    def from_yaml(cfg: dict) -> "NavStateConfig":
        from mola_lidar_odometry_tpu_torch.utils.config import as_float

        tw = cfg.get("initial_twist", [0.0] * 6)
        return NavStateConfig(
            max_time_to_use_velocity_model=as_float(cfg.get("max_time_to_use_velocity_model"), 0.75),
            sliding_window_length=as_float(cfg.get("sliding_window_length"), 0.5),
            sigma_random_walk_acceleration_linear=as_float(
                cfg.get("sigma_random_walk_acceleration_linear"), 1.0
            ),
            sigma_random_walk_acceleration_angular=as_float(
                cfg.get("sigma_random_walk_acceleration_angular"), 10.0
            ),
            sigma_integrator_position=as_float(cfg.get("sigma_integrator_position"), 1.0),
            sigma_integrator_orientation=as_float(cfg.get("sigma_integrator_orientation"), 1.0),
            initial_twist=tuple(float(as_float(x)) for x in tw),
            initial_twist_sigma_lin=as_float(cfg.get("initial_twist_sigma_lin"), 20.0),
            initial_twist_sigma_ang=as_float(cfg.get("initial_twist_sigma_ang"), 3.0),
            robust_param=as_float(cfg.get("robust_param"), 0.0),
            max_rmse=as_float(cfg.get("max_rmse"), 0.0),
        )


class NavStateBuffer(NamedTuple):
    """Ring buffers of fused poses (chronological by construction)."""

    times: torch.Tensor  # (B, W) f32
    R: torch.Tensor  # (B, W, 3, 3) f32
    t: torch.Tensor  # (B, W, 3) f32
    valid: torch.Tensor  # (B, W) bool
    head: torch.Tensor  # (B,) i32 — next write slot

    @staticmethod
    def empty(batch: int, device="cuda") -> "NavStateBuffer":
        return NavStateBuffer(
            times=torch.zeros((batch, WINDOW), dtype=torch.float32, device=device),
            R=torch.eye(3, device=device).expand(batch, WINDOW, 3, 3).clone(),
            t=torch.zeros((batch, WINDOW, 3), dtype=torch.float32, device=device),
            valid=torch.zeros((batch, WINDOW), dtype=torch.bool, device=device),
            head=torch.zeros((batch,), dtype=torch.int32, device=device),
        )


class NavStateEstimate(NamedTuple):
    pose: Pose
    twist: torch.Tensor  # (B, 6) body twist [v, w]
    valid: torch.Tensor  # (B,) bool — "hasMotionModel"
    prior: PosePrior  # ICP prior built from pose + horizon-scaled info


def fuse_pose(buf: NavStateBuffer, time: torch.Tensor, pose: Pose) -> NavStateBuffer:
    slot = torch.arange(WINDOW, device=buf.times.device) == (buf.head % WINDOW)[:, None]  # (B, W)
    return NavStateBuffer(
        times=torch.where(slot, time[:, None].to(torch.float32), buf.times),
        R=torch.where(slot[..., None, None], pose.R[:, None], buf.R),
        t=torch.where(slot[..., None], pose.t[:, None], buf.t),
        valid=buf.valid | slot,
        head=buf.head + 1,
    )


def _chronological(buf: NavStateBuffer):
    """Entries oldest->newest: ring order starting at head."""
    idx = ((buf.head[:, None] + torch.arange(WINDOW, device=buf.head.device)) % WINDOW).long()
    g = lambda x: torch.gather(x, 1, idx.view(idx.shape + (1,) * (x.dim() - 2)).expand_as(x))  # noqa: E731
    return g(buf.times), g(buf.R), g(buf.t), g(buf.valid)


def estimate(buf: NavStateBuffer, cfg: NavStateConfig, t_query: torch.Tensor) -> NavStateEstimate:
    dev = buf.times.device
    t_query = t_query.to(torch.float32)
    times, Rs, ts, valid = _chronological(buf)
    tq = t_query[:, None]
    in_window = valid & (tq - times <= cfg.sliding_window_length + cfg.max_time_to_use_velocity_model)
    any_valid = torch.any(valid, dim=-1)
    idx = torch.arange(WINDOW, device=dev)
    safe_last = torch.clamp(torch.amax(torch.where(valid, idx, -1), dim=-1), min=0)
    bi = torch.arange(times.shape[0], device=dev)
    last_pose = Pose(Rs[bi, safe_last], ts[bi, safe_last])
    last_time = times[bi, safe_last]

    pair_ok = in_window[:, :-1] & in_window[:, 1:]
    dt = times[:, 1:] - times[:, :-1]
    pair_ok = pair_ok & (dt > 1e-6)
    rel = se3.compose(se3.inverse(Pose(Rs[:, :-1], ts[:, :-1])), Pose(Rs[:, 1:], ts[:, 1:]))
    xi = se3.se3_log(rel)  # (B, W-1, 6)
    safe_dt = torch.where(pair_ok, dt, 1.0)
    tw_pairs = xi / safe_dt[..., None]
    tau = max(cfg.sliding_window_length / 4.0, 1e-3)
    age = tq - times[:, 1:]
    w = torch.where(pair_ok, dt * dt * torch.exp(-torch.clamp(age, min=0.0) / tau), 0.0)
    wsum = torch.sum(w, dim=-1, keepdim=True)
    have_pairs = wsum > 0
    wn = w / torch.where(have_pairs, wsum, 1.0)
    init_tw = torch.tensor(cfg.initial_twist, dtype=torch.float32, device=dev)
    sl = max(cfg.initial_twist_sigma_lin, 1e-6)
    sa = max(cfg.initial_twist_sigma_ang, 1e-6)
    w0 = torch.tensor([1.0 / sl**2] * 3 + [1.0 / sa**2] * 3, dtype=torch.float32, device=dev)
    rob2 = cfg.robust_param * cfg.robust_param
    rw = torch.ones_like(wn)
    twist = init_tw.expand(times.shape[0], 6)
    for _ in range(3 if cfg.robust_param > 0 else 1):
        den = torch.sum(wn * rw, dim=-1, keepdim=True) + w0
        num = torch.sum(tw_pairs * (wn * rw)[..., None], dim=1) + w0 * init_tw
        twist = num / den
        if cfg.robust_param > 0:
            r2 = torch.sum((tw_pairs - twist[:, None]) ** 2, dim=-1)
            rw = torch.where(pair_ok, (rob2 / (r2 + rob2)) ** 2, 0.0)
    if cfg.max_rmse > 0:
        rmse = torch.sqrt(torch.sum(wn * torch.sum((tw_pairs - twist[:, None]) ** 2, dim=-1), dim=-1))
        twist = torch.where((have_pairs[:, 0] & (rmse > cfg.max_rmse))[:, None], init_tw, twist)
    twist = torch.where(have_pairs, twist, init_tw)

    horizon = t_query - last_time
    model_ok = any_valid & (horizon >= 0) & (horizon <= cfg.max_time_to_use_velocity_model)
    pose_q = se3.compose(last_pose, se3.se3_exp(twist * horizon[:, None]))
    sp = cfg.sigma_integrator_position + 0.5 * cfg.sigma_random_walk_acceleration_linear * horizon**2
    so = cfg.sigma_integrator_orientation + 0.5 * cfg.sigma_random_walk_acceleration_angular * horizon**2
    inv_p = 1.0 / torch.clamp(sp * sp, min=1e-12)
    inv_o = 1.0 / torch.clamp(so * so, min=1e-12)
    diag = torch.stack([inv_p] * 3 + [inv_o] * 3, dim=-1)
    info = torch.diag_embed(diag) * model_ok.to(torch.float32)[:, None, None]
    ok = model_ok[:, None]
    return NavStateEstimate(
        pose=Pose(torch.where(ok[..., None], pose_q.R, last_pose.R), torch.where(ok, pose_q.t, last_pose.t)),
        twist=torch.where(ok, twist, 0.0),
        valid=model_ok,
        prior=PosePrior(pose_q, info),
    )
