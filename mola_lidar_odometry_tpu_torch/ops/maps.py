"""Local-map layer definitions and the operations the step and ICP apply.

Port of ``mola_lidar_odometry_tpu/ops/maps.py``.  Point map classes
(``HashedVoxelPointCloud`` and the plain point layers it serves) map to
:class:`~.voxel_hash.VoxelHashMap`, ``NDT`` to :class:`~.ndt.NdtMap`,
``CVoxelMap`` to :class:`~.occupancy.OccupancyMap`; dispatch is on the
state's type, as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from mola_lidar_odometry_tpu_torch.ops import ndt, occupancy, pallas_match, voxel_hash
from mola_lidar_odometry_tpu_torch.ops.pointcloud import PointCloud, on_device
from mola_lidar_odometry_tpu_torch.utils.expr import Expr, as_expr

_POINT_CLASSES = (
    "HashedVoxelPointCloud", "SparseTreesPointCloud", "CPointsMap", "CSimplePointsMap",
    "CPointsMapXYZI", "CPointsMapXYZIRT",
)


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
    # CVoxelMap (occupancy)
    prob_hit: float = 0.7
    prob_miss: float = 0.3
    clamp_min: float = 0.05
    clamp_max: float = 0.95
    occupied_threshold: float = 0.6
    ray_trace_free_space: bool = True
    max_ray_samples: int = 512  # static step budget of the free-space walk per beam

    def create(self, voxel_size, batch: int, device="cuda"):
        if self.map_class in _POINT_CLASSES:
            return voxel_hash.VoxelHashMap.create(
                self.num_slots, self.points_per_voxel, voxel_size, batch, device
            )
        if self.map_class == "NDT":
            return ndt.NdtMap.create(self.num_slots, voxel_size, self.max_eigen_ratio_for_planes, batch, device)
        if self.map_class == "CVoxelMap":
            return occupancy.OccupancyMap.create(
                self.num_slots, voxel_size, batch, device, prob_hit=self.prob_hit, prob_miss=self.prob_miss,
                clamp_min=self.clamp_min, clamp_max=self.clamp_max, occupied_threshold=self.occupied_threshold,
            )
        raise ValueError(f"Unsupported metric map class {self.map_class!r}")


def map_def_from_yaml(name: str, md: dict, num_slots: int) -> MapLayerDef:
    """Parse one ``metric_map_definition`` YAML block."""
    from mola_lidar_odometry_tpu_torch.utils.config import as_bool, as_float, as_str

    cls = as_str(md.get("class", "mola::HashedVoxelPointCloud")).split("::")[-1]
    creation = md.get("creationOpts", {}) or {}
    ins = md.get("insertOpts", {}) or {}
    lik = md.get("likelihoodOpts", {}) or {}
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
        prob_hit=as_float(ins.get("prob_hit"), 0.7),
        prob_miss=as_float(ins.get("prob_miss"), 0.3),
        clamp_min=as_float(ins.get("clamp_min"), 0.05),
        clamp_max=as_float(ins.get("clamp_max"), 0.95),
        occupied_threshold=as_float(lik.get("occupiedThreshold"), 0.6),
        ray_trace_free_space=as_bool(ins.get("ray_trace_free_space"), default=True),
    )


def insert(state, pc: PointCloud, sensor_origin=None, layer_def: MapLayerDef = None):
    """Insert into any map layer; :func:`insert_stats` without its counters."""
    return insert_stats(state, pc, sensor_origin, layer_def)[0]


def insert_stats(state, pc: PointCloud, sensor_origin=None, layer_def: MapLayerDef = None):
    """Insert + capacity-pressure counters (``voxel_hash.InsertStats``)."""
    md = layer_def.min_distance_between_points if layer_def else 0.0
    if isinstance(state, voxel_hash.VoxelHashMap):
        bud = layer_def.insert_budget if layer_def else 0
        return voxel_hash.insert_stats(state, pc, min_distance=md, budget=bud)
    if isinstance(state, ndt.NdtMap):
        return ndt.insert_stats(state, pc, min_distance=md)
    if isinstance(state, occupancy.OccupancyMap):
        return occupancy.insert_stats(
            state, pc, sensor_origin, ray_trace=layer_def.ray_trace_free_space if layer_def else True,
            max_ray_samples=layer_def.max_ray_samples if layer_def else 512,
        )
    raise TypeError(type(state))


def prune_farther_than(state, center, distance):
    """Drop every voxel farther than ``distance`` from ``center`` (B, 3)."""
    if isinstance(state, voxel_hash.VoxelHashMap):
        return voxel_hash.prune_farther_than(state, center, distance)
    if isinstance(state, ndt.NdtMap):
        return ndt.prune_farther_than(state, center, distance)
    if isinstance(state, occupancy.OccupancyMap):
        return occupancy.prune_farther_than(state, center, distance)
    raise TypeError(type(state))


def prune_farther_than_amortized(state, center, distance, step_idx):
    """Per-step eviction sweep: the rolling slab of the point-map tables,
    the full prune of the small NDT and occupancy tables."""
    if isinstance(state, voxel_hash.VoxelHashMap):
        return voxel_hash.prune_farther_than_slab(state, center, distance, step_idx)
    return prune_farther_than(state, center, distance)


def is_empty(state) -> torch.Tensor:
    return state.is_empty()


def clear(state):
    return state.clear()


def clear_where(state, mask: torch.Tensor):
    """``clear()`` of the instances where ``mask`` (B,) holds."""
    if isinstance(state, occupancy.OccupancyMap):
        return state._replace(
            used=state.used & ~mask[:, None], logodds=torch.where(mask[:, None], 0.0, state.logodds),
            match=clear_where(state.match, mask),
        )
    return state._replace(epoch=torch.where(mask, state.epoch + 1, state.epoch))


def set_voxel_size(state, voxel_size):
    """Set each instance's voxel size (a float or a (B,) tensor); an
    occupancy map's match grid follows."""
    vs = on_device(voxel_size, torch.float32, state.voxel_size.device).expand(state.voxel_size.shape[0]).contiguous()
    if isinstance(state, occupancy.OccupancyMap):
        return state.set_voxel_size(vs)
    if not isinstance(state, (voxel_hash.VoxelHashMap, ndt.NdtMap)):
        raise TypeError(type(state))
    return state._replace(voxel_size=vs)


def capture(state, queries, neighbors: int = 27, per_voxel_nn: bool = False):
    """Gather the neighbourhood candidate set once (``voxel_hash.capture``,
    ``ndt.capture``)."""
    if isinstance(state, voxel_hash.VoxelHashMap):
        return voxel_hash.capture(state, queries, neighbors, per_voxel_nn)
    if isinstance(state, ndt.NdtMap):
        return ndt.capture(state, queries, neighbors)
    if isinstance(state, occupancy.OccupancyMap):
        return occupancy.capture(state, queries, neighbors)
    raise TypeError(type(state))


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


def query_p2p2(state, queries, valid, *, neighbors: int = 27):
    """Two-nearest query (``pairingsPerPoint: 2``)."""
    return match_p2p2(capture(state, queries, neighbors), queries, valid)


def query_p2pl(state, queries, valid, *, search_radius: float = 0.8, min_plane_points: int = 6,
               plane_eigen_threshold: float = 1e-2, neighbors: int = 27):
    """Point-to-plane query: ``(plane_pt, normal, dist2, found)``."""
    return match_p2pl(
        capture(state, queries, neighbors), queries, valid, search_radius=search_radius,
        min_plane_points=min_plane_points, plane_eigen_threshold=plane_eigen_threshold,
    )


def as_pointcloud(state, capacity: int, anchor=None) -> PointCloud:
    """Flatten a map layer to a point view: a point map's points (the
    wrapped keys unwrapped near ``anchor`` (B, 3), the robot pose, or
    without one near the anchor its live keys give), an NDT
    map's live voxel means, an occupancy map's occupied voxel centers."""
    if isinstance(state, voxel_hash.VoxelHashMap):
        return voxel_hash.as_pointcloud(state, capacity, anchor)
    if isinstance(state, ndt.NdtMap):
        return PointCloud.from_xyz(state.means(), valid=state.n() > 0).compact(capacity)
    if isinstance(state, occupancy.OccupancyMap):
        return occupancy.as_pointcloud(state, capacity)
    raise TypeError(type(state))
