"""Pose prior and robust kernel of the Gauss-Newton solver.

Port of the main-path subset of ``mola_lidar_odometry_tpu/ops/solver.py``:
the fused align kernel (B3) carries the whole Gauss-Newton loop itself, so
the port needs only the prior container and the Geman-McClure weight.  The
generic block solver and Horn's closed form are ROADMAP queue A items.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mola_lidar_odometry_tpu_torch.ops.se3 import Pose


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
