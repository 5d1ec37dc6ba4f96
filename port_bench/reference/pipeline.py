"""A pipeline YAML read for the plain reference, with no code of the program.

The reference works out from the YAML what the program's set-up derives
from it: the filter graph, the ICP blocks, the map layers and the
thresholds.  Only what the benchmark's pipelines use is read (voxel, range,
box, deskew, delete and timestamp filters; point-to-point matchers on
voxel point maps; the Gauss-Newton solver); anything else raises, so a
pipeline the reference cannot follow is never compared.

Expressions (``2.0*max(ADAPTIVE_THRESHOLD_SIGMA, ...)``) are evaluated in
float64 Python arithmetic; ``^`` is the power.  ``${NAME|default}`` takes
the default: the benchmark runs every pipeline as shipped, whatever the
environment holds.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import yaml

_FUNCS = dict(max=max, min=min, sqrt=math.sqrt, abs=abs, sin=math.sin, cos=math.cos, tan=math.tan,
              asin=math.asin, acos=math.acos, atan=math.atan, atan2=math.atan2, exp=math.exp, log=math.log,
              floor=math.floor, ceil=math.ceil, pow=math.pow)


class Expr:
    """A pipeline expression, called on a dict of the dynamic variables."""

    def __init__(self, text):
        self.text = str(text).strip().strip("'\"")
        self._code = compile(self.text.replace("^", "**"), "<pipeline expression>", "eval")

    def __call__(self, env: Dict[str, float]) -> float:
        return float(eval(self._code, {"__builtins__": {}}, {**_FUNCS, **env}))

    def const(self) -> float:
        return self({})


def _closing(s: str, start: int) -> int:
    depth = 0
    for i in range(start, len(s)):
        depth += {"{": 1, "}": -1}.get(s[i], 0)
        if depth == 0:
            return i
    raise ValueError(f"unbalanced braces in {s!r}")


def substitute(text: str) -> str:
    """``${NAME|default}`` -> default, ``$f{expr}`` -> expr."""
    out, i = [], 0
    while True:
        j = text.find("$", i)
        if j < 0:
            out.append(text[i:])
            return "".join(out)
        out.append(text[i:j])
        if text.startswith("${", j) or text.startswith("$f{", j):
            open_at = j + (1 if text[j + 1] == "{" else 2)
            close = _closing(text, open_at)
            body = text[open_at + 1:close]
            if text[j + 1] == "{":
                depth, split = 0, -1
                for k, ch in enumerate(body):
                    depth += {"{": 1, "}": -1}.get(ch, 0)
                    if ch == "|" and depth == 0:
                        split = k
                        break
                if split < 0:
                    raise ValueError(f"${{{body}}} has no default")
                body = body[split + 1:]
            out.append(substitute(body))
            i = close + 1
        else:
            out.append("$")
            i = j + 1


def load(path) -> dict:
    return yaml.safe_load(substitute(Path(path).read_text()))


def _str(v, default: str = "") -> str:
    return default if v is None else str(v).strip().strip("'\"")


def _bool(v, default: bool) -> bool:
    if v is None:
        return default
    if isinstance(v, bool):
        return v
    s = _str(v).lower()
    if s in ("true", "1", "yes", "on"):
        return True
    if s in ("false", "0", "no", "off", ""):
        return False
    raise ValueError(f"cannot read {v!r} as a bool")


def _num(v, default: float) -> float:
    if v is None:
        return default
    return float(v) if isinstance(v, (int, float)) else Expr(v).const()


# ----------------------------------------------------------------------------
# the filter graph
# ----------------------------------------------------------------------------


@dataclass(frozen=True)
class AdjustTimestampsOp:
    layer: str
    method: str
    time_offset: Expr


@dataclass(frozen=True)
class DecimateOp:
    input: str
    output: str
    resolution: Expr
    method: str
    min_input_points: int


@dataclass(frozen=True)
class RangeOp:
    input: str
    between: Optional[str]
    outside: Optional[str]
    range_min: Expr
    range_max: Expr


@dataclass(frozen=True)
class BBoxOp:
    input: str
    inside: Optional[str]
    outside: Optional[str]
    bb_min: Tuple[Expr, ...]
    bb_max: Tuple[Expr, ...]


@dataclass(frozen=True)
class DeskewOp:
    input: str
    output: str
    skip: bool
    twist_vars: Tuple[str, ...]


@dataclass(frozen=True)
class DeleteOp:
    layers_to_remove: Tuple[str, ...]


def filters(entries) -> list:
    ops = []
    for entry in entries or []:
        cls = _str(entry.get("class_name")).split("::")[-1]
        p = entry.get("params") or {}
        if cls == "FilterDecimateVoxels":
            ops.append(DecimateOp(_str(p["input_pointcloud_layer"]), _str(p["output_pointcloud_layer"]),
                                  Expr(p["voxel_filter_resolution"]),
                                  _str(p.get("decimate_method"), "DecimateMethod::FirstPoint").split("::")[-1],
                                  int(_num(p.get("minimum_input_points_to_filter"), 0))))
        elif cls == "FilterByRange":
            ops.append(RangeOp(_str(p["input_pointcloud_layer"]), _str(p.get("output_layer_between")) or None,
                               _str(p.get("output_layer_outside")) or None, Expr(p.get("range_min", 0.0)),
                               Expr(p.get("range_max", 1e9))))
        elif cls == "FilterBoundingBox":
            ops.append(BBoxOp(_str(p["input_pointcloud_layer"]), _str(p.get("inside_pointcloud_layer")) or None,
                              _str(p.get("outside_pointcloud_layer")) or None,
                              tuple(Expr(v) for v in p.get("bounding_box_min", [-1e9] * 3)),
                              tuple(Expr(v) for v in p.get("bounding_box_max", [1e9] * 3))))
        elif cls == "FilterAdjustTimestamps":
            ops.append(AdjustTimestampsOp(_str(p["pointcloud_layer"]),
                                          _str(p.get("method"), "TimestampAdjustMethod::MiddleIsZero").split("::")[-1],
                                          Expr(p.get("time_offset", 0.0))))
        elif cls == "FilterDeskew":
            ops.append(DeskewOp(_str(p["input_pointcloud_layer"]), _str(p["output_pointcloud_layer"]),
                                _bool(p.get("skip_deskew"), False),
                                tuple(_str(v) for v in p.get("twist", ["vx", "vy", "vz", "wx", "wy", "wz"]))))
        elif cls == "FilterDeleteLayer":
            rm = p.get("pointcloud_layer_to_remove", [])
            ops.append(DeleteOp(tuple(_str(x) for x in ([rm] if isinstance(rm, str) else rm))))
        else:
            raise ValueError(f"the reference does not read filter {cls!r}")
    return ops


# ----------------------------------------------------------------------------
# ICP, maps and the rest
# ----------------------------------------------------------------------------


@dataclass(frozen=True)
class Matcher:
    local_layer: str
    global_layer: str
    threshold: Expr
    threshold_angular_deg: float
    weight: float
    allow_match_already_matched: bool
    run_from_iteration: int
    run_up_to_iteration: int


@dataclass(frozen=True)
class Icp:
    max_iterations: int
    min_abs_step_trans: float
    min_abs_step_rot: float
    matchers: Tuple[Matcher, ...]
    kernel_param: Expr
    gn_inner_iterations: int
    hook_min_trans: float
    hook_min_rot: float


@dataclass(frozen=True)
class MapLayer:
    name: str
    voxel_size: Expr
    remove_voxels_farther_than: Expr
    points_per_voxel: int


@dataclass(frozen=True)
class NavState:
    max_time_to_use_velocity_model: float
    sliding_window_length: float
    sigma_random_walk_acceleration_linear: float
    sigma_random_walk_acceleration_angular: float
    sigma_integrator_position: float
    sigma_integrator_orientation: float
    initial_twist: Tuple[float, ...]
    initial_twist_sigma_lin: float
    initial_twist_sigma_ang: float
    robust_param: float
    max_rmse: float


@dataclass(frozen=True)
class Adaptive:
    enabled: bool
    initial_sigma: float
    min_motion: float
    maximum_sigma: float
    kp: float
    alpha: float


@dataclass(frozen=True)
class LocalMapUpdates:
    enabled: bool
    min_translation_between_keyframes: Expr
    min_rotation_between_keyframes_deg: Expr
    max_distance_to_keep_keyframes: Expr
    check_for_removal_every_n: int
    measure_from_last_kf_only: bool


@dataclass(frozen=True)
class MapInsert:
    input_layer: str
    target_map_layer: str


@dataclass(frozen=True)
class Pipeline:
    adjust: list
    filter1: list
    filter2: list
    icp: Icp
    icp_local_layer: str
    map_layers: Tuple[MapLayer, ...]
    map_inserts: Tuple[MapInsert, ...]
    local_map_updates: LocalMapUpdates
    navstate: NavState
    adaptive_threshold: Adaptive
    min_icp_goodness: float
    absolute_minimum_sensor_range: float
    max_sensor_range_filter_coefficient: float
    min_time_between_scans: float
    optimize_twist: bool
    optimize_twist_max_corrections: int


def _icp(block: dict, hook: Tuple[float, float]) -> Icp:
    p = block.get("params") or {}
    gn = {}
    for s in block.get("solvers") or []:
        cls = _str(s.get("class"))
        if "GaussNewton" in cls:
            gn = s.get("params") or {}
        else:
            raise ValueError(f"the reference does not run solver {cls!r}")
    matchers = []
    for m in block.get("matchers") or []:
        cls = _str(m.get("class"))
        mp = m.get("params") or {}
        if not _bool(mp.get("enabled"), True):
            continue
        if "Matcher_Points_DistanceThreshold" not in cls or int(_num(mp.get("pairingsPerPoint"), 1)) != 1:
            raise ValueError(f"the reference runs single point-to-point matchers only, not {cls!r}")
        for row in mp.get("pointLayerMatches") or [{}]:
            matchers.append(Matcher(
                local_layer=_str(row.get("local"), "decimated_for_icp"), global_layer=_str(row.get("global"), "localmap"),
                threshold=Expr(mp.get("threshold", "2.0*ADAPTIVE_THRESHOLD_SIGMA")),
                threshold_angular_deg=_num(mp.get("thresholdAngularDeg"), 0.0), weight=_num(row.get("weight"), 1.0),
                allow_match_already_matched=_bool(mp.get("allowMatchAlreadyMatchedGlobalPoints"), True),
                run_from_iteration=int(_num(mp.get("runFromIteration"), 0)),
                run_up_to_iteration=int(_num(mp.get("runUpToIteration"), 0))))
    return Icp(max_iterations=int(_num(p.get("maxIterations"), 300)),
               min_abs_step_trans=_num(p.get("minAbsStep_trans"), 1e-4), min_abs_step_rot=_num(p.get("minAbsStep_rot"), 5e-5),
               matchers=tuple(matchers), kernel_param=Expr(gn.get("robustKernelParam", "0.5*ADAPTIVE_THRESHOLD_SIGMA")),
               gn_inner_iterations=int(_num(gn.get("maxIterations"), 2)), hook_min_trans=hook[0], hook_min_rot=hook[1])


def _map_layer(gen: dict) -> MapLayer:
    params = gen.get("params") or {}
    md = params.get("metric_map_definition") or {}
    cls = _str(md.get("class"), "mola::HashedVoxelPointCloud").split("::")[-1]
    if cls != "HashedVoxelPointCloud":
        raise ValueError(f"the reference keeps voxel point maps only, not {cls!r}")
    creation, ins = md.get("creationOpts") or {}, md.get("insertOpts") or {}
    if _num(ins.get("min_distance_between_points"), 0.0) != 0.0:
        raise ValueError("the reference does not thin map points")
    return MapLayer(_str(params.get("target_layer"), "localmap"), Expr(creation.get("voxel_size", 1.0)),
                    Expr(ins.get("remove_voxels_farther_than", 0.0)), int(_num(ins.get("max_points_per_voxel"), 20)))


def read(path) -> Pipeline:
    """The reference's reading of the pipeline YAML at ``path``."""
    cfg = load(path)
    params = cfg.get("params") or {}
    if cfg.get("icp_settings_without_vel"):
        raise ValueError("the reference runs one ICP block")
    optimize = _bool(params.get("optimize_twist"), True)
    hook = ((_num(params.get("optimize_twist_rerun_min_trans"), 0.15),
             math.radians(_num(params.get("optimize_twist_rerun_min_rot_deg"), 0.75))) if optimize else (0.0, 0.0))
    icp = _icp(cfg.get("icp_settings_with_vel") or {}, hook)
    inserts = []
    for entry in cfg.get("insert_observation_into_local_map") or []:
        if "FilterMerge" in _str(entry.get("class_name")):
            mp = entry.get("params") or {}
            inserts.append(MapInsert(_str(mp["input_pointcloud_layer"]), _str(mp.get("target_layer"), "localmap")))
    lm = params.get("local_map_updates") or {}
    at = params.get("adaptive_threshold") or {}
    nv = cfg.get("navstate_fuse_params") or {}
    if _bool((params.get("observation_validity_checks") or {}).get("enabled"), False):
        raise ValueError("the reference does not check observation validity")
    if _bool((cfg.get("initial_localization") or {}).get("enabled"), False):
        raise ValueError("the reference starts every instance at the identity")
    gens = cfg.get("observations_generator") or []
    if len(gens) != 1 or _str((gens[0].get("params") or {}).get("target_layer"), "raw") != "raw":
        raise ValueError("the reference reads one raw layer")
    return Pipeline(
        adjust=filters(cfg.get("observations_filter_adjust_timestamps")),
        filter1=filters(cfg.get("observations_filter_1st_pass")),
        filter2=filters(cfg.get("observations_filter_2nd_pass")),
        icp=icp, icp_local_layer=icp.matchers[0].local_layer,
        map_layers=tuple(_map_layer(g) for g in cfg.get("localmap_generator") or []),
        map_inserts=tuple(inserts),
        local_map_updates=LocalMapUpdates(
            enabled=_bool(lm.get("enabled"), True),
            min_translation_between_keyframes=Expr(lm.get("min_translation_between_keyframes", 0.0)),
            min_rotation_between_keyframes_deg=Expr(lm.get("min_rotation_between_keyframes", 0.0)),
            max_distance_to_keep_keyframes=Expr(lm.get("max_distance_to_keep_keyframes", 0.0)),
            check_for_removal_every_n=int(_num(lm.get("check_for_removal_every_n"), 100)),
            measure_from_last_kf_only=_bool(lm.get("measure_from_last_kf_only"), False)),
        navstate=NavState(
            max_time_to_use_velocity_model=_num(nv.get("max_time_to_use_velocity_model"), 0.75),
            sliding_window_length=_num(nv.get("sliding_window_length"), 0.5),
            sigma_random_walk_acceleration_linear=_num(nv.get("sigma_random_walk_acceleration_linear"), 1.0),
            sigma_random_walk_acceleration_angular=_num(nv.get("sigma_random_walk_acceleration_angular"), 10.0),
            sigma_integrator_position=_num(nv.get("sigma_integrator_position"), 1.0),
            sigma_integrator_orientation=_num(nv.get("sigma_integrator_orientation"), 1.0),
            initial_twist=tuple(_num(x, 0.0) for x in nv.get("initial_twist", [0.0] * 6)),
            initial_twist_sigma_lin=_num(nv.get("initial_twist_sigma_lin"), 20.0),
            initial_twist_sigma_ang=_num(nv.get("initial_twist_sigma_ang"), 3.0),
            robust_param=_num(nv.get("robust_param"), 0.0), max_rmse=_num(nv.get("max_rmse"), 0.0)),
        adaptive_threshold=Adaptive(
            enabled=_bool(at.get("enabled"), True), initial_sigma=_num(at.get("initial_sigma"), 2.0),
            min_motion=_num(at.get("min_motion"), 0.1), maximum_sigma=_num(at.get("maximum_sigma"), 3.0),
            kp=_num(at.get("kp"), 2.0), alpha=_num(at.get("alpha"), 0.9)),
        min_icp_goodness=_num(params.get("min_icp_goodness"), 0.25),
        absolute_minimum_sensor_range=_num(params.get("absolute_minimum_sensor_range"), 5.0),
        max_sensor_range_filter_coefficient=_num(params.get("max_sensor_range_filter_coefficient"), 0.95),
        min_time_between_scans=_num(params.get("min_time_between_scans"), 1e-3),
        optimize_twist=optimize,
        optimize_twist_max_corrections=int(_num(params.get("optimize_twist_max_corrections"), 8)),
    )


def without_registration(pipe: Pipeline) -> Pipeline:
    """The pipeline with its ICP given no iterations: the control, which
    breaks the registration the configuration states (``maxIterations``
    until the step falls under ``minAbsStep``); each pose is then the
    velocity model's prediction."""
    return replace(pipe, icp=replace(pipe.icp, max_iterations=0))
