"""Keyframe pose ring buffers — the ``mola::SearchablePoseList`` contract.

Port of ``mola_lidar_odometry_tpu/models/keyframes.py``, batched: one ring
of past insert poses per instance, queried for the relative pose to the
closest entry (or the newest with ``from_last_only``) and pruned by distance.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from mola_lidar_odometry_tpu_torch.ops import se3
from mola_lidar_odometry_tpu_torch.ops.se3 import Pose


class PoseRing(NamedTuple):
    R: torch.Tensor  # (B, C, 3, 3)
    t: torch.Tensor  # (B, C, 3)
    valid: torch.Tensor  # (B, C) bool
    head: torch.Tensor  # (B,) i32

    @staticmethod
    def empty(capacity: int, batch: int, device="cuda") -> "PoseRing":
        return PoseRing(
            R=torch.eye(3, device=device).expand(batch, capacity, 3, 3).clone(),
            t=torch.zeros((batch, capacity, 3), dtype=torch.float32, device=device),
            valid=torch.zeros((batch, capacity), dtype=torch.bool, device=device),
            head=torch.zeros((batch,), dtype=torch.int32, device=device),
        )

    @property
    def capacity(self) -> int:
        return self.t.shape[1]

    def size(self) -> torch.Tensor:
        return torch.sum(self.valid, dim=-1)


def insert(ring: PoseRing, pose: Pose) -> PoseRing:
    slot = torch.arange(ring.capacity, device=ring.t.device) == (ring.head % ring.capacity)[:, None]
    return PoseRing(
        R=torch.where(slot[..., None, None], pose.R[:, None], ring.R),
        t=torch.where(slot[..., None], pose.t[:, None], ring.t),
        valid=ring.valid | slot,
        head=ring.head + 1,
    )


def check(ring: PoseRing, pose: Pose, *, from_last_only: bool = False) -> Tuple[torch.Tensor, ...]:
    """(is_first, dist_to_closest, rot_to_closest) per instance."""
    is_first = ring.size() == 0
    bi = torch.arange(ring.t.shape[0], device=ring.t.device)
    if from_last_only:
        idx = ((ring.head - 1) % ring.capacity).long()
        sel = torch.where(ring.valid[bi, idx], idx, 0)
    else:
        d2 = torch.sum((ring.t - pose.t[:, None]) ** 2, dim=-1)
        sel = torch.argmin(torch.where(ring.valid, d2, float("inf")), dim=-1)
    dt, dr = se3.pose_error_norms(Pose(ring.R[bi, sel], ring.t[bi, sel]), pose)
    return is_first, torch.where(is_first, float("inf"), dt), torch.where(is_first, float("inf"), dr)


def remove_farther_than(ring: PoseRing, center: torch.Tensor, distance) -> PoseRing:
    """Invalidate poses farther than ``distance`` ((B,) or float) from center (B, 3)."""
    d2 = torch.sum((ring.t - center[:, None]) ** 2, dim=-1)
    dist = distance[:, None] if torch.is_tensor(distance) else distance
    return ring._replace(valid=ring.valid & (d2 <= dist * dist))
