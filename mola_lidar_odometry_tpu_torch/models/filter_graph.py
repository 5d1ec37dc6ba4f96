"""YAML filter pipelines compiled to layer-dict transforms over the fleet.

Port of ``mola_lidar_odometry_tpu/models/filter_graph.py`` for the ops the
lidar3d-default pipeline uses: Decimate (FirstPoint), Range, BBox,
AdjustTimestamps, Deskew and Delete.  Each YAML entry becomes a small
dataclass holding compiled :class:`~..utils.expr.Expr` parameters, evaluated
per frame on the ``(B,)`` dynamic-variable environment.  Any other filter
or generator class raises ``NotImplementedError`` naming its ROADMAP item.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from mola_lidar_odometry_tpu_torch.ops import filters as F
from mola_lidar_odometry_tpu_torch.ops.pointcloud import PointCloud
from mola_lidar_odometry_tpu_torch.utils.config import as_bool, as_str
from mola_lidar_odometry_tpu_torch.utils.expr import Expr, as_expr


def _col(values, like: torch.Tensor) -> torch.Tensor:
    """Stack per-instance scalars (floats or (B,) tensors) into (B, k)."""
    B, dev = like.shape[0], like.device
    return torch.stack(
        [torch.as_tensor(v, dtype=torch.float32, device=dev).expand(B) for v in values], dim=-1
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


Pipeline = List[object]


def apply_pipeline(pipeline: Pipeline, layers: Dict[str, PointCloud], env) -> Dict[str, PointCloud]:
    layers = dict(layers)
    for op in pipeline:
        op(layers, env)
    return layers


def deskew_ops(pipeline: Pipeline) -> List[DeskewOp]:
    return [op for op in pipeline if isinstance(op, DeskewOp)]


def _not_ported(kind: str, cls: str):
    return NotImplementedError(f"{kind} class {cls!r}: ROADMAP queue A, 'other filters'")


def build_generator_pipeline(yaml_list: Optional[Sequence[dict]]) -> Pipeline:
    """Compile the ``observations_generator`` list: the plain Generator
    (raw observation -> 'raw' layer) is implicit in the step."""
    for entry in yaml_list or []:
        cls = as_str(entry.get("class_name", "")).split("::")[-1]
        if cls != "Generator":
            raise _not_ported("generator", cls)
    return []


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
            if method != "FirstPoint":
                raise _not_ported("decimate method", method)
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
        elif short == "FilterMerge":
            continue  # the map-insert stage of models/step.py reads it
        else:
            raise _not_ported("filter", cls)
    return out
