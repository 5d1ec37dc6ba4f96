"""Local-map layer definitions and the operations the step and ICP apply.

Port of ``mola_lidar_odometry_tpu/ops/maps.py`` for the point-map and NDT
classes.  Point map classes (``HashedVoxelPointCloud`` and the plain point
layers it serves) map to :class:`~.voxel_hash.VoxelHashMap`, ``NDT`` to
:class:`~.ndt.NdtMap`; dispatch is on the state's type, as in the JAX
package.  The occupancy class (``CVoxelMap``) raises
``NotImplementedError`` until ROADMAP queue A's "other pipeline families"
item ports it.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from mola_lidar_odometry_tpu_torch.ops import ndt, pallas_match, voxel_hash
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
    # NDT
    max_eigen_ratio_for_planes: float = 0.05

    def create(self, voxel_size, batch: int, device="cuda"):
        if self.map_class in _POINT_CLASSES:
            return voxel_hash.VoxelHashMap.create(
                self.num_slots, self.points_per_voxel, voxel_size, batch, device
            )
        if self.map_class == "NDT":
            return ndt.NdtMap.create(self.num_slots, voxel_size, self.max_eigen_ratio_for_planes, batch, device)
        if self.map_class == "CVoxelMap":
            raise _not_ported(f"metric map class {self.map_class!r} (item 3.3, occupancy)")
        raise ValueError(f"Unsupported metric map class {self.map_class!r}")


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
        max_eigen_ratio_for_planes=as_float(ins.get("max_eigen_ratio_for_planes"), 0.05),
    )


def _unsupported(state):
    return _not_ported(f"map state {type(state).__name__}")


def insert_stats(state, pc: PointCloud, sensor_origin=None, layer_def: MapLayerDef = None):
    """Insert + capacity-pressure counters (``voxel_hash.InsertStats``)."""
    md = layer_def.min_distance_between_points if layer_def else 0.0
    if isinstance(state, voxel_hash.VoxelHashMap):
        bud = layer_def.insert_budget if layer_def else 0
        return voxel_hash.insert_stats(state, pc, min_distance=md, budget=bud)
    if isinstance(state, ndt.NdtMap):
        return ndt.insert_stats(state, pc, min_distance=md)
    raise _unsupported(state)


def prune_farther_than(state, center, distance):
    """Drop every voxel farther than ``distance`` from ``center`` (B, 3);
    the point maps' whole-table prune is their slab prune over all slabs."""
    if isinstance(state, voxel_hash.VoxelHashMap):
        zero = torch.zeros((state.data.shape[0],), dtype=torch.int64, device=state.data.device)
        return voxel_hash.prune_farther_than_slab(state, center, distance, zero, n_slabs=1)
    if isinstance(state, ndt.NdtMap):
        return ndt.prune_farther_than(state, center, distance)
    raise _unsupported(state)


def prune_farther_than_amortized(state, center, distance, step_idx):
    """Per-step eviction sweep: the rolling slab of the point-map tables,
    the full prune of the small NDT tables."""
    if isinstance(state, voxel_hash.VoxelHashMap):
        return voxel_hash.prune_farther_than_slab(state, center, distance, step_idx)
    return prune_farther_than(state, center, distance)


def is_empty(state) -> torch.Tensor:
    return state.is_empty()


def clear(state):
    return state.clear()


def set_voxel_size(state, voxel_size):
    if not isinstance(state, (voxel_hash.VoxelHashMap, ndt.NdtMap)):
        raise _unsupported(state)
    vs = on_device(voxel_size, torch.float32, state.data.device)
    return state._replace(voxel_size=vs.expand(state.data.shape[0]).contiguous())


def capture(state, queries, neighbors: int = 27, per_voxel_nn: bool = False):
    """Gather the neighbourhood candidate set once (``voxel_hash.capture``,
    ``ndt.capture``)."""
    if isinstance(state, voxel_hash.VoxelHashMap):
        return voxel_hash.capture(state, queries, neighbors, per_voxel_nn)
    if isinstance(state, ndt.NdtMap):
        return ndt.capture(state, queries, neighbors)
    raise _unsupported(state)


def match_p2p(candset, queries, valid):
    """Nearest cached candidate: ``(tgt, d2, found)``.  A planar candidate
    set goes through kernel B4 (``pallas_match.nn_select``)."""
    if isinstance(candset, voxel_hash.CandSet):
        return voxel_hash.nn_from(candset, queries, valid)
    if isinstance(candset, ndt.NdtCandSet):
        return ndt.p2p_from(candset, queries, valid)
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


def match_p2pl(candset, queries, valid, *, search_radius=0.8, min_plane_points=6, plane_eigen_threshold=1e-2):
    """Point-to-plane pairing: ``(plane_pt, normal, d2, found)``.  NDT
    layers use their stored planes; point layers fit a plane per query."""
    if isinstance(candset, ndt.NdtCandSet):
        return ndt.p2pl_from(candset, queries, valid)
    if isinstance(candset, voxel_hash.CandSet):
        return voxel_hash.p2pl_from(
            candset, queries, valid, search_radius=search_radius, min_plane_points=min_plane_points,
            plane_eigen_threshold=plane_eigen_threshold,
        )
    raise TypeError(f"point-to-plane matching unsupported for {type(candset)}")


def query_p2p(state, queries, valid, *, neighbors: int = 27):
    """Nearest-target query: ``(target_xyz, dist2, found)``."""
    return match_p2p(capture(state, queries, neighbors), queries, valid)


def query_p2pl(state, queries, valid, *, search_radius: float = 0.8, min_plane_points: int = 6,
               plane_eigen_threshold: float = 1e-2, neighbors: int = 27):
    """Point-to-plane query: ``(plane_pt, normal, dist2, found)``."""
    return match_p2pl(
        capture(state, queries, neighbors), queries, valid, search_radius=search_radius,
        min_plane_points=min_plane_points, plane_eigen_threshold=plane_eigen_threshold,
    )


def as_pointcloud(state, capacity: int, anchor) -> PointCloud:
    """Flatten a map layer to a point view: a point map's points (the
    wrapped keys unwrapped near ``anchor`` (B, 3), the robot pose), an NDT
    map's live voxel means."""
    if isinstance(state, voxel_hash.VoxelHashMap):
        return voxel_hash.as_pointcloud(state, capacity, anchor)
    if isinstance(state, ndt.NdtMap):
        return PointCloud.from_xyz(state.means(), valid=state.n() > 0).compact(capacity)
    raise _unsupported(state)
