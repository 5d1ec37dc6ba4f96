"""Fleet of odometry instances on one device.

Port of the single-device part of ``mola_lidar_odometry_tpu/parallel/batch.py``
that the bench runs: the fleet is the explicit leading dimension B of every
carry and scan tensor, so the fleet step is the step itself.  The JAX
package's ``shard_map`` fleet over a device mesh is ROADMAP queue A's
"multi-GPU fleet" item.
"""

from __future__ import annotations

import numpy as np
import torch

from mola_lidar_odometry_tpu_torch.models import step as step_mod
from mola_lidar_odometry_tpu_torch.models.spec import OdometrySpec
from mola_lidar_odometry_tpu_torch.models.step import Carry, Scan


def init_fleet_carry(spec: OdometrySpec, batch: int, device="cuda") -> Carry:
    """``batch`` fresh carries stacked on the leading dimension."""
    return step_mod.init_carry(spec, batch, device)


def make_fleet_step(spec: OdometrySpec):
    """(Carry[B], Scan[B]) -> (Carry[B], StepOutput[B])."""
    return step_mod.make_step(spec)


def pack_scans(spec: OdometrySpec, scans, stamps, device="cuda") -> Scan:
    """Pad a list of (xyz, times, rings, valid[, intensity]) numpy scans
    into a batched Scan (intensity 0 where a scan has none)."""
    b, n = len(scans), spec.raw_capacity
    xyz = np.zeros((b, n, 3), np.float32)
    tms = np.zeros((b, n), np.float32)
    inten = np.zeros((b, n), np.float32)
    rng = np.zeros((b, n), np.int32)
    val = np.zeros((b, n), bool)
    for i, (x, t, r, v, *rest) in enumerate(scans):
        k = min(len(x), n)
        xyz[i, :k], tms[i, :k], rng[i, :k], val[i, :k] = x[:k], t[:k], r[:k], v[:k]
        if rest:
            inten[i, :k] = rest[0][:k]

    def dev(a):
        return torch.from_numpy(a).to(device)

    return Scan(
        xyz=dev(xyz), time=dev(tms), intensity=dev(inten), ring=dev(rng), valid=dev(val),
        stamp=dev(np.asarray(stamps, np.float32)),
    )
