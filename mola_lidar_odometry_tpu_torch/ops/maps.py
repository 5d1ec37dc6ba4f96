"""Local-map layer definitions and the operations the step and ICP apply.

Port of the voxel branch of ``mola_lidar_odometry_tpu/ops/maps.py``.  Point
map classes (``HashedVoxelPointCloud`` and the plain point layers it serves)
map to :class:`~.voxel_hash.VoxelHashMap`; the NDT and occupancy classes and
point-to-plane matching raise ``NotImplementedError`` until ROADMAP queue
A's "other pipeline families" item ports them.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from mola_lidar_odometry_tpu_torch.ops import pallas_match, voxel_hash
from mola_lidar_odometry_tpu_torch.ops.pointcloud import PointCloud, on_device
from mola_lidar_odometry_tpu_torch.utils.expr import Expr, as_expr

_POINT_CLASSES = (
    "HashedVoxelPointCloud", "SparseTreesPointCloud", "CPointsMap", "CSimplePointsMap",
    "CPointsMapXYZI", "CPointsMapXYZIRT",
)


def _not_ported(what: str):
    return NotImplementedError(f"{what}: ROADMAP queue A, 'other pipeline families'")


@dataclass(frozen=True)
class MapLayerDef:
    """Static definition of one local-map layer (from ``localmap_generator``)."""

    name: str = "localmap"
    map_class: str = "HashedVoxelPointCloud"
    num_slots: int = 1 << 18
    voxel_size: Expr = field(default_factory=lambda: Expr("1.0"))
    remove_voxels_farther_than: Expr = field(default_factory=lambda: Expr("0"))
    points_per_voxel: int = 20
    min_distance_between_points: float = 0.0
    # static per-frame budget for the insert scatter (0 = unbounded)
    insert_budget: int = 0

    def create(self, voxel_size, batch: int, device="cuda") -> voxel_hash.VoxelHashMap:
        if self.map_class not in _POINT_CLASSES:
            raise _not_ported(f"metric map class {self.map_class!r}")
        return voxel_hash.VoxelHashMap.create(
            self.num_slots, self.points_per_voxel, voxel_size, batch, device
        )


def map_def_from_yaml(name: str, md: dict, num_slots: int) -> MapLayerDef:
    """Parse one ``metric_map_definition`` YAML block."""
    from mola_lidar_odometry_tpu_torch.utils.config import as_float, as_str

    cls = as_str(md.get("class", "mola::HashedVoxelPointCloud")).split("::")[-1]
    creation = md.get("creationOpts", {}) or {}
    ins = md.get("insertOpts", {}) or {}
    voxel = creation.get("voxel_size", creation.get("resolution", 1.0))
    if cls == "SparseTreesPointCloud":
        voxel = creation.get("grid_size", voxel)
    return MapLayerDef(
        name=name,
        map_class=cls,
        num_slots=num_slots,
        voxel_size=as_expr(voxel),
        remove_voxels_farther_than=as_expr(ins.get("remove_voxels_farther_than", 0.0)),
        points_per_voxel=int(float(ins.get("max_points_per_voxel", 20) or 20)),
        min_distance_between_points=as_float(ins.get("min_distance_between_points"), 0.0),
    )


def _check(state):
    if not isinstance(state, voxel_hash.VoxelHashMap):
        raise _not_ported(f"map state {type(state).__name__}")


def insert_stats(state, pc: PointCloud, sensor_origin=None, layer_def: MapLayerDef = None):
    """Insert + capacity-pressure counters (voxel_hash.InsertStats)."""
    _check(state)
    md = layer_def.min_distance_between_points if layer_def else 0.0
    bud = layer_def.insert_budget if layer_def else 0
    return voxel_hash.insert_stats(state, pc, min_distance=md, budget=bud)


def prune_farther_than_amortized(state, center, distance, step_idx):
    """Per-step eviction sweep: the rolling slab of the point-map tables."""
    _check(state)
    return voxel_hash.prune_farther_than_slab(state, center, distance, step_idx)


def is_empty(state) -> torch.Tensor:
    return state.is_empty()


def clear(state):
    return state.clear()


def set_voxel_size(state, voxel_size):
    _check(state)
    vs = on_device(voxel_size, torch.float32, state.data.device)
    return state._replace(voxel_size=vs.expand(state.data.shape[0]).contiguous())


def capture(state, queries, neighbors: int = 27, per_voxel_nn: bool = False):
    """Gather the neighbourhood candidate set once (``voxel_hash.capture``)."""
    _check(state)
    return voxel_hash.capture(state, queries, neighbors, per_voxel_nn)


def match_p2p(candset, queries, valid):
    """Nearest cached candidate: ``(tgt, d2, found)``.  A planar candidate
    set goes through kernel B4 (``pallas_match.nn_select``)."""
    if isinstance(candset, voxel_hash.CandSet):
        return voxel_hash.nn_from(candset, queries, valid)
    if isinstance(candset, pallas_match.PlanarCands):
        tgt, d2 = pallas_match.nn_select(candset, queries)
        found = valid & (d2 < 1e37)
        return tgt, torch.where(found, d2, torch.inf), found
    raise TypeError(type(candset))


def match_p2p2(candset, queries, valid):
    """Two nearest cached candidates (``pairingsPerPoint: 2``)."""
    if isinstance(candset, voxel_hash.CandSet):
        return voxel_hash.nn2_from(candset, queries, valid)
    raise TypeError(f"pairingsPerPoint=2 unsupported for {type(candset)}")


def match_p2pl(candset, queries, valid, **_):
    raise _not_ported("point-to-plane matching (Matcher_Point2Plane)")


def as_pointcloud(state, capacity: int, anchor) -> PointCloud:
    """Flatten a map layer to a point view (``voxel_hash.as_pointcloud``,
    the wrapped keys unwrapped near ``anchor`` (B, 3), the robot pose)."""
    _check(state)
    return voxel_hash.as_pointcloud(state, capacity, anchor)
