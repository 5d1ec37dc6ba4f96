"""Odometry pipeline specification: YAML -> static config.

Port of ``mola_lidar_odometry_tpu/models/spec.py``.  Mirrors the reference's
``Parameters`` block tree (reference module/include/mola_lidar_odometry/
LidarOdometry.h:109-394, loaders module/src/LidarOdometry.cpp:125-483).
Numeric fields that the reference declares as Parameterizable expressions
stay :class:`Expr` and are evaluated per frame on the fleet's ``(B,)``
dynamic variables.

Unlike the JAX package, the port reads no ``MOLA_TPU_*`` environment
switches: every ICP block gets the algorithm the JAX package runs on a TPU
by default (per-voxel top-2 capture, fused two-phase align, refresh by
reselect, 8 probes for single-matcher configs), the insert budget follows
the "auto" rule, and capacities come from the caller.

The spec holds only what the fleet step reads.  The reference's host-side
block (sensor labels, the worker queue, multi-LiDAR merging, trajectory and
debug-trace files, map loading and saving, ``start_active``) belongs to the
``LidarOdometry`` host API, not ported yet (ROADMAP queue A): the port's
entry point takes scans directly, so labels and the queue bound have nothing
to act on, and a YAML that asks for one of the other host effects raises
``NotImplementedError`` instead of being ignored.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

from mola_lidar_odometry_tpu_torch.models.filter_graph import Pipeline, build_pipeline
from mola_lidar_odometry_tpu_torch.models.navstate import NavStateConfig
from mola_lidar_odometry_tpu_torch.ops.icp import HornCfg, IcpConfig, MatcherCfg
from mola_lidar_odometry_tpu_torch.ops.maps import MapLayerDef, map_def_from_yaml
from mola_lidar_odometry_tpu_torch.utils.config import as_bool, as_float, as_str
from mola_lidar_odometry_tpu_torch.utils.expr import Expr, as_expr


@dataclass(frozen=True)
class AdaptiveThresholdCfg:
    """KISS-ICP adaptive sigma (reference LidarOdometry.h:252-263)."""

    enabled: bool = True
    initial_sigma: float = 2.0
    min_motion: float = 0.1
    maximum_sigma: float = 3.0
    kp: float = 2.0
    alpha: float = 0.9


@dataclass(frozen=True)
class LocalMapUpdatesCfg:
    enabled: bool = True
    min_translation_between_keyframes: Expr = field(default_factory=lambda: Expr("0"))
    min_rotation_between_keyframes_deg: Expr = field(default_factory=lambda: Expr("0"))
    max_distance_to_keep_keyframes: Expr = field(default_factory=lambda: Expr("0"))
    check_for_removal_every_n: int = 100
    measure_from_last_kf_only: bool = False


@dataclass(frozen=True)
class SimpleMapCfg:
    generate: bool = False
    min_translation_between_keyframes: Expr = field(default_factory=lambda: Expr("1"))
    min_rotation_between_keyframes_deg: Expr = field(default_factory=lambda: Expr("15"))
    add_non_keyframes_too: bool = False
    measure_from_last_kf_only: bool = False


@dataclass(frozen=True)
class MapInsertOp:
    """One FilterMerge entry of ``insert_observation_into_local_map``
    (reference pipelines/lidar3d-default.yaml:362-368): transform the named
    observation layer by the robot pose and insert it into a map layer."""

    input_layer: str
    target_map_layer: str


@dataclass(frozen=True)
class ObservationValidityCfg:
    enabled: bool = False
    check_layer_name: str = "raw"
    minimum_point_count: int = 1000


@dataclass(frozen=True)
class InitialLocalizationCfg:
    enabled: bool = False
    fixed_initial_pose: Tuple[float, ...] = (0.0,) * 6  # x y z yaw pitch roll


@dataclass(frozen=True)
class OdometrySpec:
    """Everything needed to build the scan step."""

    # capacities (static buffer shapes)
    raw_capacity: int = 1 << 17
    layer_capacities: Dict[str, int] = field(default_factory=dict)

    # pipelines
    generator_pipeline: Pipeline = field(default_factory=list)
    adjust_pipeline: Pipeline = field(default_factory=list)
    filter1: Pipeline = field(default_factory=list)
    filter2: Pipeline = field(default_factory=list)
    filter_final: Pipeline = field(default_factory=list)

    # ICP
    icp_with_vel: IcpConfig = field(default_factory=IcpConfig)
    icp_without_vel: IcpConfig = field(default_factory=IcpConfig)
    icp_local_layer: str = "decimated_for_icp"

    # local map: named layers + insert graph
    map_layers: Tuple[MapLayerDef, ...] = field(
        default_factory=lambda: (MapLayerDef(),)
    )
    map_inserts: Tuple[MapInsertOp, ...] = field(
        default_factory=lambda: (MapInsertOp("decimated_for_map", "localmap"),)
    )
    local_map_updates: LocalMapUpdatesCfg = field(default_factory=LocalMapUpdatesCfg)
    # SE(2) pinning: pin z/pitch/roll with 1e6 information (the reference does
    # this whenever the observation is a 2D scan, LidarOdometry.cpp:863-876).
    # None = auto: the host API inspects the first scan and pins when it is
    # planar (a 2D range scan); True/False forces.
    pin_se2: Optional[bool] = None

    # state / gating
    navstate: NavStateConfig = field(default_factory=NavStateConfig)
    adaptive_threshold: AdaptiveThresholdCfg = field(default_factory=AdaptiveThresholdCfg)
    min_icp_goodness: float = 0.25
    absolute_minimum_sensor_range: float = 5.0
    max_sensor_range_filter_coefficient: float = 0.95
    min_time_between_scans: float = 1e-3
    optimize_twist: bool = True
    optimize_twist_max_corrections: int = 8
    optimize_twist_rerun_min_trans: float = 0.15
    optimize_twist_rerun_min_rot_deg: float = 0.75

    simplemap: SimpleMapCfg = field(default_factory=SimpleMapCfg)
    observation_validity: ObservationValidityCfg = field(default_factory=ObservationValidityCfg)
    initial_localization: InitialLocalizationCfg = field(default_factory=InitialLocalizationCfg)

    # KF ring capacities
    kf_ring_capacity: int = 512


def _icp_from_yaml(block: dict, spec_hook: Tuple[float, float]) -> Tuple[IcpConfig, str]:
    """Parse an ``icp_settings_*`` YAML block (matchers, solvers, params).

    Returns (IcpConfig, primary_local_layer) — the primary local layer (first
    matcher's) drives the sensor-range estimate and point-count stats.
    """
    p = block.get("params", {}) or {}
    solvers = block.get("solvers", []) or []
    matchers = block.get("matchers", []) or []

    gn: dict = {}
    horn: Optional[HornCfg] = None
    for s in solvers:
        cls = as_str(s.get("class", ""))
        sp = s.get("params", {}) or {}
        if "GaussNewton" in cls:
            gn = sp
        elif "Horn" in cls and as_bool(sp.get("enabled"), default=True):
            horn = HornCfg(
                run_until_translation_correction_smaller_than=as_float(
                    sp.get("runUntilTranslationCorrectionSmallerThan"), 5e-4
                )
            )
    kernel = gn.get("robustKernelParam", "0.5*ADAPTIVE_THRESHOLD_SIGMA")

    mcfgs = []
    for m in matchers:
        cls = as_str(m.get("class", ""))
        mp = m.get("params", {}) or {}
        if not as_bool(mp.get("enabled"), default=True):
            continue
        if "Matcher_Point2Plane" in cls:
            kind = "point2plane"
            thr = mp.get("distanceThreshold", "1.0*ADAPTIVE_THRESHOLD_SIGMA")
        elif "Matcher_Points_DistanceThreshold" in cls:
            kind = "point2point"
            thr = mp.get("threshold", "2.0*ADAPTIVE_THRESHOLD_SIGMA")
        else:
            raise ValueError(f"Unsupported matcher class {cls!r}")
        ppp = int(float(mp.get("pairingsPerPoint", 1) or 1))
        run_from = int(float(mp.get("runFromIteration", 0) or 0))
        run_upto = int(float(mp.get("runUpToIteration", 0) or 0))
        for row in mp.get("pointLayerMatches") or [
            {"local": "decimated_for_icp", "global": "localmap", "weight": 1.0}
        ]:
            mcfgs.append(
                MatcherCfg(
                    kind=kind,
                    local_layer=as_str(row.get("local", "decimated_for_icp")),
                    global_layer=as_str(row.get("global", "localmap")),
                    threshold=as_expr(thr),
                    threshold_angular_deg=as_float(mp.get("thresholdAngularDeg"), 0.0),
                    pairings_per_point=ppp,
                    weight=as_float(row.get("weight"), 1.0),
                    run_from_iteration=run_from,
                    run_up_to_iteration=run_upto,
                    allow_match_already_matched=as_bool(
                        mp.get("allowMatchAlreadyMatchedGlobalPoints"), default=True
                    ),
                    search_radius=as_float(mp.get("searchRadius"), 0.8),
                    min_plane_points=int(float(mp.get("minimumPlanePoints", 6) or 6)),
                    plane_eigen_threshold=as_float(mp.get("planeEigenThreshold"), 1e-2),
                )
            )
    if not mcfgs:
        mcfgs = [MatcherCfg()]

    hook_trans, hook_rot = spec_hook
    cfg = IcpConfig(
        max_iterations=int(float(p.get("maxIterations", 300))),
        min_abs_step_trans=as_float(p.get("minAbsStep_trans"), 1e-4),
        min_abs_step_rot=as_float(p.get("minAbsStep_rot"), 5e-5),
        matchers=tuple(mcfgs),
        kernel_param=as_expr(kernel),
        gn_inner_iterations=int(float(gn.get("maxIterations", 2))),
        horn=horn,
        # probe footprint: 8 (nearest 2x2x2 block) for single-matcher
        # configs, 27 (full 3x3x3) for multi-matcher ones — the JAX
        # package's per-config default
        nn_neighbors=8 if len(mcfgs) == 1 else 27,
        hook_min_trans=hook_trans,
        hook_min_rot=hook_rot,
    )
    return cfg, mcfgs[0].local_layer


def _reject_host_effects(params: dict) -> None:
    """Raise for reference options whose effect lives in the unported host
    API: merging several LiDARs, writing trajectory or trace files, loading
    or saving maps, starting paused."""

    def sub(key):
        return params.get(key, {}) or {}

    def on(block, key):
        return as_bool(block.get(key), default=False)

    def named(block, key):
        return bool(as_str(block.get(key, "")))

    lm, sm = sub("local_map_updates"), sub("simplemap")
    asked = {
        "multiple_lidars.lidar_count > 1": int(float(sub("multiple_lidars").get("lidar_count", 1))) > 1,
        "estimated_trajectory.save_to_file": on(sub("estimated_trajectory"), "save_to_file"),
        "debug_traces.save_to_file": on(sub("debug_traces"), "save_to_file"),
        "start_active: false": not as_bool(params.get("start_active"), default=True),
        "local_map_updates.load_existing_local_map": named(lm, "load_existing_local_map"),
        "simplemap.load_existing_simple_map": named(sm, "load_existing_simple_map"),
        "simplemap.generate_lazy_load_scan_files": on(sm, "generate_lazy_load_scan_files"),
        "simplemap.generate with save_final_map_to_file": (
            on(sm, "generate") and named(sm, "save_final_map_to_file")
        ),
    }
    bad = [k for k, hit in asked.items() if hit]
    if bad:
        raise NotImplementedError(
            f"{', '.join(bad)}: host-side options of the LidarOdometry API, "
            "not ported yet (ROADMAP queue A, 'LidarOdometry host API')"
        )


def _map_layers_from_yaml(gen_list, num_slots: int) -> Tuple[MapLayerDef, ...]:
    """Parse the ``localmap_generator`` list into per-layer map definitions."""
    if not gen_list:
        return (MapLayerDef(num_slots=num_slots),)
    defs = []
    for gen in gen_list:
        params = (gen or {}).get("params", {}) or {}
        md = params.get("metric_map_definition", {}) or {}
        name = as_str(params.get("target_layer", "localmap"))
        defs.append(map_def_from_yaml(name, md, num_slots))
    return tuple(defs)


def spec_from_yaml(cfg: dict, **overrides) -> OdometrySpec:
    """Build an :class:`OdometrySpec` from a loaded pipeline YAML dict.

    ``overrides`` replaces top-level spec fields (CLI flags beat YAML, like
    the reference's apps/mola-lidar-odometry-cli.cpp:391-399).
    """
    params = cfg.get("params", {}) or {}
    _reject_host_effects(params)

    raw_capacity = int(overrides.pop("raw_capacity", 1 << 17))
    num_slots = int(overrides.pop("map_slots", 1 << 18))
    layer_capacities = dict(overrides.pop("layer_capacities", {}))
    layer_capacities.setdefault("raw", raw_capacity)

    hook_enabled = as_bool(params.get("optimize_twist"), default=True)
    hook_trans = as_float(params.get("optimize_twist_rerun_min_trans"), 0.15)
    hook_rot_deg = as_float(params.get("optimize_twist_rerun_min_rot_deg"), 0.75)
    import math

    hook = (hook_trans, math.radians(hook_rot_deg)) if hook_enabled else (0.0, 0.0)

    icp_with, local_layer = _icp_from_yaml(cfg.get("icp_settings_with_vel", {}) or {}, hook)
    without_block = cfg.get("icp_settings_without_vel")
    if without_block:
        icp_without, _ = _icp_from_yaml(without_block, hook)
    else:
        icp_without = icp_with  # reference default: same as with_vel

    lm = params.get("local_map_updates", {}) or {}
    sm = params.get("simplemap", {}) or {}
    at = params.get("adaptive_threshold", {}) or {}
    ovc = params.get("observation_validity_checks", {}) or {}
    init_loc = cfg.get("initial_localization", {}) or {}

    # filter pipelines
    from mola_lidar_odometry_tpu_torch.models.filter_graph import build_generator_pipeline

    gen = build_generator_pipeline(cfg.get("observations_generator"))
    adjust = build_pipeline(cfg.get("observations_filter_adjust_timestamps"), layer_capacities)
    f1 = build_pipeline(cfg.get("observations_filter_1st_pass"), layer_capacities)
    f2 = build_pipeline(cfg.get("observations_filter_2nd_pass"), layer_capacities)
    ff = build_pipeline(cfg.get("observations_filter_final_pass"), layer_capacities)

    # map-insert graph from insert_observation_into_local_map FilterMerge ops
    map_inserts = []
    for entry in cfg.get("insert_observation_into_local_map", []) or []:
        if "FilterMerge" in as_str(entry.get("class_name", "")):
            mp = entry.get("params", {}) or {}
            map_inserts.append(
                MapInsertOp(
                    input_layer=as_str(mp["input_pointcloud_layer"]),
                    target_map_layer=as_str(mp.get("target_layer", "localmap")),
                )
            )
    map_layers = _map_layers_from_yaml(cfg.get("localmap_generator"), num_slots)
    if not map_inserts:
        map_inserts = [MapInsertOp("decimated_for_map", map_layers[0].name)]

    # Per-layer insert budget (voxel_hash.insert_stats): a measured budget
    # from ``insert_budgets`` when given, else max(4096, n//2) for source
    # layers above 8192 points — the JAX package's "auto" rule.  Overflow
    # is deferred, not lost (deferred_drops counts it).
    import dataclasses as _dc

    measured_budgets = dict(overrides.pop("insert_budgets", {}) or {})
    by_target = {}
    for op in map_inserts:
        n_in = int(layer_capacities.get(op.input_layer, raw_capacity))
        by_target[op.target_map_layer] = max(by_target.get(op.target_map_layer, 0), n_in)
    new_layers = []
    for d in map_layers:
        n_in = by_target.get(d.name, 0)
        if d.name in measured_budgets:
            bud = int(measured_budgets[d.name])
        else:
            bud = max(4096, n_in // 2) if n_in > 8192 else 0
        if bud and d.map_class in (
            "HashedVoxelPointCloud", "SparseTreesPointCloud", "CPointsMap",
            "CSimplePointsMap", "CPointsMapXYZI", "CPointsMapXYZIRT",
        ):
            d = _dc.replace(d, insert_budget=min(bud, n_in) if n_in else bud)
        new_layers.append(d)
    map_layers = tuple(new_layers)

    fixed_pose = tuple(
        float(as_float(x)) for x in init_loc.get("fixed_initial_pose", [0.0] * 6)
    )

    spec = OdometrySpec(
        raw_capacity=raw_capacity,
        layer_capacities=layer_capacities,
        generator_pipeline=gen,
        adjust_pipeline=adjust,
        filter1=f1,
        filter2=f2,
        filter_final=ff,
        icp_with_vel=icp_with,
        icp_without_vel=icp_without,
        icp_local_layer=local_layer,
        map_layers=map_layers,
        map_inserts=tuple(map_inserts),
        pin_se2=(
            as_bool(params.get("pin_se2"), default=False)
            if params.get("pin_se2") is not None
            else None
        ),
        local_map_updates=LocalMapUpdatesCfg(
            enabled=as_bool(lm.get("enabled"), default=True),
            min_translation_between_keyframes=as_expr(lm.get("min_translation_between_keyframes", 0.0)),
            min_rotation_between_keyframes_deg=as_expr(lm.get("min_rotation_between_keyframes", 0.0)),
            max_distance_to_keep_keyframes=as_expr(lm.get("max_distance_to_keep_keyframes", 0.0)),
            check_for_removal_every_n=int(float(lm.get("check_for_removal_every_n", 100))),
            measure_from_last_kf_only=as_bool(lm.get("measure_from_last_kf_only"), default=False),
        ),
        navstate=NavStateConfig.from_yaml(cfg.get("navstate_fuse_params", {}) or {}),
        adaptive_threshold=AdaptiveThresholdCfg(
            enabled=as_bool(at.get("enabled"), default=True),
            initial_sigma=as_float(at.get("initial_sigma"), 2.0),
            min_motion=as_float(at.get("min_motion"), 0.1),
            maximum_sigma=as_float(at.get("maximum_sigma"), 3.0),
            kp=as_float(at.get("kp"), 2.0),
            alpha=as_float(at.get("alpha"), 0.9),
        ),
        min_icp_goodness=as_float(params.get("min_icp_goodness"), 0.25),
        absolute_minimum_sensor_range=as_float(params.get("absolute_minimum_sensor_range"), 5.0),
        max_sensor_range_filter_coefficient=as_float(
            params.get("max_sensor_range_filter_coefficient"), 0.95
        ),
        min_time_between_scans=as_float(params.get("min_time_between_scans"), 1e-3),
        optimize_twist=hook_enabled,
        optimize_twist_max_corrections=int(float(params.get("optimize_twist_max_corrections", 8))),
        optimize_twist_rerun_min_trans=hook_trans,
        optimize_twist_rerun_min_rot_deg=hook_rot_deg,
        simplemap=SimpleMapCfg(
            generate=as_bool(sm.get("generate"), default=False),
            min_translation_between_keyframes=as_expr(sm.get("min_translation_between_keyframes", 1.0)),
            min_rotation_between_keyframes_deg=as_expr(sm.get("min_rotation_between_keyframes", 15.0)),
            add_non_keyframes_too=as_bool(sm.get("add_non_keyframes_too"), default=False),
            measure_from_last_kf_only=as_bool(sm.get("measure_from_last_kf_only"), default=False),
        ),
        observation_validity=ObservationValidityCfg(
            enabled=as_bool(ovc.get("enabled"), default=False),
            check_layer_name=as_str(ovc.get("check_layer_name", "raw")),
            minimum_point_count=int(float(ovc.get("minimum_point_count", 1000))),
        ),
        initial_localization=InitialLocalizationCfg(
            enabled=as_bool(init_loc.get("enabled"), default=False),
            fixed_initial_pose=fixed_pose,
        ),
    )
    if overrides:
        from dataclasses import replace

        spec = replace(spec, **overrides)
    return spec
