"""Carry state across the two packages as nested numpy arrays.

A fleet carry of the JAX package, converted leaf by leaf with ``np.asarray``
(``jax.tree_util.tree_map(np.asarray, carry)``), has the same field names as
the port's :class:`~..models.step.Carry`: :func:`carry_from_numpy` turns it
into the port's tensors, :func:`carry_to_numpy` goes the other way.  The map
tables keep their layout word for word ((rows, 128) int32 W-way buckets,
12|12|8 pkeys, ``epoch << 16 | count`` state words, 10|10|10 packed
points), so both packages can start from one identical state.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from mola_lidar_odometry_tpu_torch.models import keyframes, navstate as ns
from mola_lidar_odometry_tpu_torch.models.step import Carry
from mola_lidar_odometry_tpu_torch.ops.voxel_hash import VoxelHashMap

_NESTED = {"nav": ns.NavStateBuffer, "lm_kfs": keyframes.PoseRing, "sm_kfs": keyframes.PoseRing}


def _convert(tree: Any, leaf) -> Carry:
    fields = {}
    for name in Carry._fields:
        v = getattr(tree, name)
        if name in _NESTED:
            cls = _NESTED[name]
            fields[name] = cls(*(leaf(getattr(v, f)) for f in cls._fields))
        elif name == "maps":
            fields[name] = {
                k: VoxelHashMap(leaf(m.voxel_size), leaf(m.data), leaf(m.epoch), int(m.K), int(m.stride))
                for k, m in v.items()
            }
        else:
            fields[name] = leaf(v)
    return Carry(**fields)


def carry_from_numpy(tree: Any, device="cuda") -> Carry:
    """A carry with numpy leaves (either package's field names) -> the
    port's :class:`Carry` on ``device``.  Every leaf is copied: the port
    updates its map tables in place."""
    return _convert(tree, lambda x: torch.from_numpy(np.array(x, copy=True)).to(device))


def carry_to_numpy(carry: Carry) -> Carry:
    """The port's carry with every tensor copied to a numpy array."""
    return _convert(carry, lambda x: x.detach().cpu().numpy().copy())
