"""Capacity sizing policy: derive buffer sizes from the first scan.

Port of ``mola_lidar_odometry_tpu/utils/capacity.py``.  A host-side dry pass
over the FIRST scan sizes every buffer:

  * every filter-graph layer is sized by running the pipeline once in exact
    host arithmetic (``utils/exact_filters.py``, the float64 interpreter of
    the same compiled spec the device step runs) and measuring the layer
    populations;
  * the map hash table is sized from the measured unique-voxel count of the
    map-insert layers at each map's own resolution, times a fill factor.

The constants, margins and quanta are the JAX package's, so both packages
derive the same integers from the same scan (the reasons for each value,
measured on the JAX package's own hardware, are in that module).  Saturation
stays observable at run time: ``StepOutput.map_collision_drops`` feeds a
windowed warning in ``models/odometry.py``.
"""

from __future__ import annotations

import math
import os
from typing import Dict

import numpy as np

from mola_lidar_odometry_tpu_torch.utils import exact_filters as O


def _round_up(n: int, m: int) -> int:
    return ((max(n, 1) + m - 1) // m) * m


def _next_pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 1).bit_length()


# layer populations vary frame to frame (deskew, range-estimate drift moves
# the decimation resolutions): 1.25x over the first scan, in 512-row quanta
LAYER_MARGIN = 1.25
LAYER_QUANTUM = 512
# the insert budget covers a bring-up frame's unique voxels with room for
# depth fill (models/spec.py budget resolution)
BUDGET_MARGIN = 1.5
RAW_QUANTUM = 8192
# hash slots per unique first-scan voxel: the sliding map holds several
# keyframes of fresh voxels, and a voxel drops when every way of its bucket
# is taken.  MOLA_MAP_SLOTS_FACTOR overrides it, as in the JAX package.
MAP_SLOTS_FACTOR = int(os.environ.get("MOLA_MAP_SLOTS_FACTOR", "16"))
MAP_SLOTS_MIN = 1 << 12
MAP_SLOTS_MAX = 1 << 20


def derive_capacities(
    spec,
    xyz: np.ndarray,
    times: np.ndarray = None,
    with_budgets: bool = False,
    known_max_points: int = None,
):
    """Dry-run the spec's filter graph on the first scan (exact host
    arithmetic) and derive ``(raw_capacity, map_slots, layer_capacities)``;
    with ``with_budgets=True`` a 4th element: per-map-layer insert budgets
    from the measured unique-voxel count.

    ``known_max_points``: when the caller knows the largest scan of the
    whole sequence, the raw buffer is sized exactly to it instead of 1.25x
    the first scan (the margin guards against a partial first revolution).
    """
    xyz = np.asarray(xyz, np.float64)
    n = len(xyz)
    if times is None:
        times = np.zeros(n)
    times = np.asarray(times, np.float64)

    rng = float(np.max(np.linalg.norm(xyz, axis=1))) if n else 0.0
    est_range = max(rng, spec.absolute_minimum_sensor_range)

    # first-frame dynamic environment (same variables models/step publishes)
    env = {
        k: 0.0
        for k in (
            "vx", "vy", "vz", "wx", "wy", "wz",
            "robot_x", "robot_y", "robot_z",
            "robot_yaw", "robot_pitch", "robot_roll",
            "ICP_ITERATION", "icp_iterations", "SENSOR_TIME_OFFSET",
            "twistCorrectionCount", "current_relative_timestamp",
        )
    }
    env["ADAPTIVE_THRESHOLD_SIGMA"] = spec.adaptive_threshold.initial_sigma
    env["ESTIMATED_SENSOR_MAX_RANGE"] = est_range
    env["INSTANTANEOUS_SENSOR_MAX_RANGE"] = est_range

    layers = {"raw": O.Cloud(xyz, times)}
    layers = O.apply_pipeline_exact(spec.adjust_pipeline, layers, env)
    layers = O.apply_pipeline_exact(spec.filter1, layers, env)
    layers = O.apply_pipeline_exact(spec.filter2, layers, env)

    # 1.25x headroom (a partial first revolution), in 8k quanta; the
    # truncation watchdog in models/odometry.py covers the rest
    if known_max_points is not None:
        raw_capacity = _round_up(max(n, int(known_max_points)), RAW_QUANTUM)
    else:
        raw_capacity = _round_up(int(n * 1.25), RAW_QUANTUM)
    caps: Dict[str, int] = {"raw": raw_capacity}
    for name, c in layers.items():
        if name == "raw":
            continue
        caps[name] = _round_up(int(math.ceil(len(c.xyz) * LAYER_MARGIN)), LAYER_QUANTUM)

    # unique voxels of every map-insert source at its target layer's
    # resolution -> hash-table sizing
    defs = {d.name: d for d in spec.map_layers}
    vox_total = 0
    vox_by_target: Dict[str, int] = {}
    for op in spec.map_inserts:
        src = layers.get(op.input_layer)
        d = defs.get(op.target_map_layer)
        if src is None or d is None or len(src.xyz) == 0:
            continue
        vs = float(np.asarray(d.voxel_size(env), np.float64))
        keys = np.floor(src.xyz / max(vs, 1e-6)).astype(np.int64)
        nv = len(np.unique(keys, axis=0))
        vox_total += nv
        vox_by_target[op.target_map_layer] = max(vox_by_target.get(op.target_map_layer, 0), nv)
    map_slots = int(
        min(max(_next_pow2(vox_total * MAP_SLOTS_FACTOR), MAP_SLOTS_MIN), MAP_SLOTS_MAX)
    )
    if not with_budgets:
        return raw_capacity, map_slots, caps
    # budget = 1.5x measured unique voxels: bring-up coverage plus some
    # depth fill
    budgets = {
        name: _round_up(int(math.ceil(nv * BUDGET_MARGIN)), LAYER_QUANTUM)
        for name, nv in vox_by_target.items()
    }
    return raw_capacity, map_slots, caps, budgets
