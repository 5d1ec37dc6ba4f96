"""YAML filter pipelines compiled to layer-dict transforms over the fleet.

Port of ``mola_lidar_odometry_tpu/models/filter_graph.py``: Decimate,
Range, BBox, AdjustTimestamps, Deskew, Delete, NormalizeIntensity,
ByIntensity and Curvature filters, and the EdgesFromRangeImage generator.
Each YAML entry becomes a small dataclass holding compiled
:class:`~..utils.expr.Expr` parameters, evaluated per frame on the ``(B,)``
dynamic-variable environment.  An unknown class raises ``ValueError``, as
in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from mola_lidar_odometry_tpu_torch.ops import filters as F
from mola_lidar_odometry_tpu_torch.ops.pointcloud import PointCloud, on_device
from mola_lidar_odometry_tpu_torch.parallel import point_axis as pa
from mola_lidar_odometry_tpu_torch.utils.config import as_bool, as_float, as_str
from mola_lidar_odometry_tpu_torch.utils.expr import Expr, as_expr


def _col(values, like: torch.Tensor) -> torch.Tensor:
    """Stack per-instance scalars (floats or (B,) tensors) into (B, k)."""
    B, dev = like.shape[0], like.device
    return torch.stack(
        [on_device(v, torch.float32, dev).expand(B) for v in values], dim=-1
    )


@dataclass(frozen=True)
class DecimateOp:
    input: str
    output: str
    resolution: Expr
    out_capacity: int
    method: str = "FirstPoint"
    min_input_points: int = 0

    def __call__(self, layers, env):
        layers[self.output] = F.decimate_voxels(
            layers[self.input], self.resolution(env), self.out_capacity,
            method=self.method, min_input_points=self.min_input_points,
        )


@dataclass(frozen=True)
class RangeOp:
    input: str
    between: Optional[str]
    outside: Optional[str]
    range_min: Expr
    range_max: Expr

    def __call__(self, layers, env):
        btw, out = F.filter_by_range(layers[self.input], self.range_min(env), self.range_max(env))
        if self.between:
            layers[self.between] = btw
        if self.outside:
            layers[self.outside] = out


@dataclass(frozen=True)
class BBoxOp:
    input: str
    inside: Optional[str]
    outside: Optional[str]
    bb_min: Tuple[Expr, Expr, Expr]
    bb_max: Tuple[Expr, Expr, Expr]

    def __call__(self, layers, env):
        pc = layers[self.input]
        mn = _col([e(env) for e in self.bb_min], pc.valid)
        mx = _col([e(env) for e in self.bb_max], pc.valid)
        ins, out = F.filter_bounding_box(pc, mn, mx)
        if self.inside:
            layers[self.inside] = ins
        if self.outside:
            layers[self.outside] = out


@dataclass(frozen=True)
class AdjustTimestampsOp:
    layer: str
    method: str = "MiddleIsZero"
    time_offset: Expr = field(default_factory=lambda: Expr("0"))

    def __call__(self, layers, env):
        if self.layer in layers:
            layers[self.layer] = F.adjust_timestamps(
                layers[self.layer], method=self.method, offset=self.time_offset(env)
            )


@dataclass(frozen=True)
class DeskewOp:
    input: str
    output: str
    skip: bool = False
    twist_vars: Tuple[str, ...] = ("vx", "vy", "vz", "wx", "wy", "wz")

    def __call__(self, layers, env):
        pc = layers[self.input]
        tw = _col([env[v] for v in self.twist_vars], pc.valid)
        layers[self.output] = F.deskew(pc, tw, skip=self.skip)


@dataclass(frozen=True)
class DeleteOp:
    layers_to_remove: Tuple[str, ...]

    def __call__(self, layers, env):
        for name in self.layers_to_remove:
            layers.pop(name, None)


@dataclass(frozen=True)
class NormalizeIntensityOp:
    layer: str

    def __call__(self, layers, env):
        layers[self.layer] = F.normalize_intensity(layers[self.layer])


@dataclass(frozen=True)
class ByIntensityOp:
    """FilterByIntensity: route points by normalized intensity into
    low/between/high output layers (extras/lidar3d-intensity.yaml:271-276)."""

    input: str
    low: Expr
    high: Expr
    out_low: Optional[str] = None
    out_between: Optional[str] = None
    out_high: Optional[str] = None

    def __call__(self, layers, env):
        pc = layers[self.input]
        lo, hi = F.per_instance(self.low(env)), F.per_instance(self.high(env))
        if self.out_low:
            layers[self.out_low] = pc.with_mask(pc.intensity < lo)
        if self.out_between:
            layers[self.out_between] = pc.with_mask((pc.intensity >= lo) & (pc.intensity <= hi))
        if self.out_high:
            layers[self.out_high] = pc.with_mask(pc.intensity > hi)


@dataclass(frozen=True)
class CurvatureOp:
    """FilterCurvature: split by local curvature along each ring
    (extras/lidar3d-edges.yaml:252-259)."""

    input: str
    out_larger: Optional[str] = None
    out_smaller: Optional[str] = None
    max_cosine: float = 0.5
    min_clearance: float = 0.02
    max_gap: float = 1e9

    def __call__(self, layers, env):
        pc = layers[self.input]
        edge = F.curvature_mask(
            pc, max_cosine=self.max_cosine, min_clearance=self.min_clearance, max_gap=self.max_gap
        )
        if self.out_larger:
            layers[self.out_larger] = pc.with_mask(edge)
        if self.out_smaller:
            layers[self.out_smaller] = pc.with_mask(~edge)


@dataclass(frozen=True)
class EdgesFromRangeImageOp:
    """GeneratorEdgesFromRangeImage: split the organized 'raw' scan into
    edge and plane point layers (reference pipelines/rgbd.yaml:233-244)."""

    target_layer: str = "edges"
    planes_target_layer: Optional[str] = "planes"
    score_threshold: float = 10.0
    row_window_length: int = 6

    def __call__(self, layers, env):
        pc = layers["raw"]
        edge = F.range_image_edge_mask(
            pc, score_threshold=self.score_threshold, row_window_length=self.row_window_length
        )
        layers[self.target_layer] = pc.with_mask(edge)
        if self.planes_target_layer:
            layers[self.planes_target_layer] = pc.with_mask(~edge)


Pipeline = List[object]


def apply_pipeline(pipeline: Pipeline, layers: Dict[str, PointCloud], env, axis=None) -> Dict[str, PointCloud]:
    """Run the ops in order on a copy of ``layers``.  Under a point axis
    (``parallel/point_axis.py``) a layer may be a ``PointSlice``, this
    rank's slice of the scan: see :func:`_apply_on_axis`."""
    layers = dict(layers)
    for op in pipeline:
        if axis is None:
            op(layers, env)
        else:
            _apply_on_axis(op, layers, env, axis)
    return layers


def _apply_on_axis(op, layers: Dict[str, PointCloud], env, axis) -> None:
    """One op under a point axis.  Per-point ops (range, box, deskew,
    intensity band, delete) run on the slice and keep it a slice.  The
    timestamp shift and the intensity scale all-reduce their min / max.
    Decimation keeps the first point of a voxel in scan order, and the
    curvature and range-image masks compare a point with its neighbours in
    buffer order, so their input is gathered in rank order first: a
    FirstPoint decimation reads only the valid points, packed in order
    (``gather_compact``), the others the whole padded layer, which then
    replaces the slice.  Their outputs are whole, the same on every rank."""
    if isinstance(op, AdjustTimestampsOp) and isinstance(layers.get(op.layer), pa.PointSlice):
        layers[op.layer] = F.adjust_timestamps(
            layers[op.layer], method=op.method, offset=op.time_offset(env), axis=axis
        )
    elif isinstance(op, NormalizeIntensityOp) and isinstance(layers[op.layer], pa.PointSlice):
        layers[op.layer] = F.normalize_intensity(layers[op.layer], axis=axis)
    elif isinstance(op, DecimateOp) and isinstance(layers[op.input], pa.PointSlice):
        pc = layers[op.input]
        if op.method == "FirstPoint":
            whole = pa.gather_compact(pc, pc.capacity * axis.size, axis)
        else:
            whole = layers[op.input] = pa.gather_cloud(pc, axis)
        scratch = {op.input: whole}
        op(scratch, env)
        layers[op.output] = scratch[op.output]
    elif isinstance(op, (CurvatureOp, EdgesFromRangeImageOp)):
        name = op.input if isinstance(op, CurvatureOp) else "raw"
        layers[name] = pa.gather_cloud(layers[name], axis)
        op(layers, env)
    else:
        op(layers, env)


def deskew_ops(pipeline: Pipeline) -> List[DeskewOp]:
    return [op for op in pipeline if isinstance(op, DeskewOp)]


def build_generator_pipeline(yaml_list: Optional[Sequence[dict]]) -> Pipeline:
    """Compile the ``observations_generator`` list: the plain Generator
    (raw observation -> 'raw' layer) is implicit in the step; specialised
    generators become ops that derive further layers from it."""
    out: Pipeline = []
    for entry in yaml_list or []:
        cls = as_str(entry.get("class_name", "")).split("::")[-1]
        p = entry.get("params", {}) or {}
        if cls == "Generator":
            continue
        if cls != "GeneratorEdgesFromRangeImage":
            raise ValueError(f"Unsupported generator class {cls!r}")
        out.append(
            EdgesFromRangeImageOp(
                target_layer=as_str(p.get("target_layer", "edges")),
                planes_target_layer=as_str(p.get("planes_target_layer", "")) or None,
                score_threshold=float(as_float(p.get("score_threshold"), 10.0)),
                row_window_length=int(float(p.get("row_window_length", 6) or 6)),
            )
        )
    return out


def _default_capacity(layer_name: str, capacities: Dict[str, int]) -> int:
    if layer_name in capacities:
        return capacities[layer_name]
    return 8192 if "icp" in layer_name else 65536


def build_pipeline(yaml_list: Optional[Sequence[dict]], capacities: Dict[str, int]) -> Pipeline:
    """Compile a YAML filter list (``observations_filter_*`` block) to ops."""
    out: Pipeline = []
    for entry in yaml_list or []:
        cls = as_str(entry.get("class_name", ""))
        short = cls.split("::")[-1]
        p = entry.get("params", {}) or {}
        if short == "FilterDecimateVoxels":
            dst = as_str(p["output_pointcloud_layer"])
            method = as_str(p.get("decimate_method", "DecimateMethod::FirstPoint")).split("::")[-1]
            out.append(
                DecimateOp(
                    input=as_str(p["input_pointcloud_layer"]),
                    output=dst,
                    resolution=as_expr(p["voxel_filter_resolution"]),
                    out_capacity=_default_capacity(dst, capacities),
                    method=method,
                    min_input_points=int(float(p.get("minimum_input_points_to_filter", 0) or 0)),
                )
            )
        elif short == "FilterByRange":
            out.append(
                RangeOp(
                    input=as_str(p["input_pointcloud_layer"]),
                    between=as_str(p.get("output_layer_between", "")) or None,
                    outside=as_str(p.get("output_layer_outside", "")) or None,
                    range_min=as_expr(p.get("range_min", 0.0)),
                    range_max=as_expr(p.get("range_max", 1e9)),
                )
            )
        elif short == "FilterBoundingBox":
            out.append(
                BBoxOp(
                    input=as_str(p["input_pointcloud_layer"]),
                    inside=as_str(p.get("inside_pointcloud_layer", "")) or None,
                    outside=as_str(p.get("outside_pointcloud_layer", "")) or None,
                    bb_min=tuple(as_expr(v) for v in p.get("bounding_box_min", [-1e9] * 3)),
                    bb_max=tuple(as_expr(v) for v in p.get("bounding_box_max", [1e9] * 3)),
                )
            )
        elif short == "FilterAdjustTimestamps":
            out.append(
                AdjustTimestampsOp(
                    layer=as_str(p["pointcloud_layer"]),
                    method=as_str(p.get("method", "TimestampAdjustMethod::MiddleIsZero")).split("::")[-1],
                    time_offset=as_expr(p.get("time_offset", 0.0)),
                )
            )
        elif short == "FilterDeskew":
            out.append(
                DeskewOp(
                    input=as_str(p["input_pointcloud_layer"]),
                    output=as_str(p["output_pointcloud_layer"]),
                    skip=as_bool(p.get("skip_deskew"), default=False),
                    twist_vars=tuple(as_str(v) for v in p.get("twist", ["vx", "vy", "vz", "wx", "wy", "wz"])),
                )
            )
        elif short == "FilterDeleteLayer":
            rm = p.get("pointcloud_layer_to_remove", [])
            out.append(DeleteOp(layers_to_remove=tuple(as_str(x) for x in ([rm] if isinstance(rm, str) else rm))))
        elif short == "FilterNormalizeIntensity":
            out.append(NormalizeIntensityOp(layer=as_str(p["pointcloud_layer"])))
        elif short == "FilterByIntensity":
            out.append(
                ByIntensityOp(
                    input=as_str(p["input_pointcloud_layer"]),
                    low=as_expr(p.get("low_threshold", 0.0)),
                    high=as_expr(p.get("high_threshold", 1.0)),
                    out_low=as_str(p.get("output_layer_low_intensity", "")) or None,
                    out_between=as_str(p.get("output_layer_mid_intensity", p.get("output_layer_between", ""))) or None,
                    out_high=as_str(p.get("output_layer_high_intensity", "")) or None,
                )
            )
        elif short == "FilterCurvature":
            out.append(
                CurvatureOp(
                    input=as_str(p["input_pointcloud_layer"]),
                    out_larger=as_str(p.get("output_layer_larger_curvature", "")) or None,
                    out_smaller=as_str(p.get("output_layer_smaller_curvature", "")) or None,
                    max_cosine=float(as_float(p.get("max_cosine"), 0.5)),
                    min_clearance=float(as_float(p.get("min_clearance"), 0.02)),
                    max_gap=float(as_float(p.get("max_gap"), 1e9)),
                )
            )
        elif short == "FilterMerge":
            continue  # the map-insert stage of models/step.py reads it
        else:
            raise ValueError(f"Unsupported filter class {cls!r}")
    return out
