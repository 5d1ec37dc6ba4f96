"""Float64 host interpreter of the filter graph.

Port of the exact-filter part of ``mola_lidar_odometry_tpu/oracle.py``
(:417-540): the same ``Cloud``, FirstPoint and ClosestToAverage voxel
decimations, Rodrigues deskew and op-by-op interpretation of a compiled
pipeline, reading the port's op classes (``models/filter_graph.py``).  It
runs on numpy in float64, so its layer populations are what the pipeline
keeps in exact arithmetic; ``utils/capacity.py`` sizes the device buffers
from them.  An op class the port's `build_pipeline` does not produce raises.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np

from mola_lidar_odometry_tpu_torch.models import filter_graph as FG


@dataclass
class Cloud:
    xyz: np.ndarray  # (N, 3) f64
    time: np.ndarray  # (N,) f64


def _f(x) -> float:
    return float(np.asarray(x, np.float64))


def _decimate_first_point(pts: np.ndarray, times: np.ndarray, res: float):
    """Exact FirstPoint voxel decimation: first input point per voxel."""
    keys = np.floor(pts / res).astype(np.int64)
    seen: Dict[Tuple[int, int, int], None] = {}
    keep = np.zeros(len(pts), bool)
    for i, k in enumerate(map(tuple, keys)):
        if k not in seen:
            seen[k] = None
            keep[i] = True
    return pts[keep], times[keep]


def _decimate_closest_to_average(pts: np.ndarray, times: np.ndarray, res: float):
    """Exact ClosestToAverage: per voxel, keep the point nearest the voxel
    centroid (lowest input index breaks ties); winners in input order."""
    keys = np.floor(pts / res).astype(np.int64)
    groups: Dict[Tuple[int, int, int], list] = {}
    for i, k in enumerate(map(tuple, keys)):
        groups.setdefault(k, []).append(i)
    keep = np.zeros(len(pts), bool)
    for idxs in groups.values():
        sub = pts[idxs]
        d2 = np.sum((sub - sub.mean(axis=0)) ** 2, axis=1)
        keep[idxs[int(np.argmin(d2))]] = True
    return pts[keep], times[keep]


def _deskew(c: Cloud, twist: np.ndarray) -> Cloud:
    """Vectorized per-point ``R(w*dt) p + v*dt`` (Rodrigues, f64)."""
    v, w = twist[:3], twist[3:]
    dt = c.time[:, None]
    phi = w[None, :] * dt  # (N, 3)
    th = np.linalg.norm(phi, axis=1, keepdims=True)
    th_safe = np.where(th < 1e-12, 1.0, th)
    k = phi / th_safe
    p = c.xyz
    kxp = np.cross(k, p)
    kdp = np.sum(k * p, axis=1, keepdims=True)
    s, cth = np.sin(th), np.cos(th)
    rot = p * cth + kxp * s + k * kdp * (1.0 - cth)
    out = np.where(th < 1e-12, p, rot) + v[None, :] * dt
    return Cloud(out, c.time)


def apply_pipeline_exact(pipeline, layers: Dict[str, Cloud], env: Dict[str, float]) -> Dict[str, Cloud]:
    """Interpret the spec's compiled filter ops with exact f64 semantics."""
    layers = dict(layers)
    for op in pipeline:
        if isinstance(op, FG.AdjustTimestampsOp):
            c = layers.get(op.layer)
            if c is None or len(c.time) == 0:
                continue
            tmin, tmax = float(c.time.min()), float(c.time.max())
            if op.method == "MiddleIsZero":
                shift = 0.5 * (tmin + tmax)
            elif op.method == "EarliestIsZero":
                shift = tmin
            else:
                raise ValueError(op.method)
            layers[op.layer] = Cloud(c.xyz, c.time - shift + _f(op.time_offset(env)))
        elif isinstance(op, FG.DecimateOp):
            c = layers[op.input]
            if len(c.xyz) < op.min_input_points:
                layers[op.output] = Cloud(c.xyz.copy(), c.time.copy())
                continue
            if op.method == "FirstPoint":
                p, t = _decimate_first_point(c.xyz, c.time, _f(op.resolution(env)))
            elif op.method == "ClosestToAverage":
                p, t = _decimate_closest_to_average(c.xyz, c.time, _f(op.resolution(env)))
            else:
                raise ValueError(f"exact filters: unsupported DecimateMethod {op.method}")
            layers[op.output] = Cloud(p, t)
        elif isinstance(op, FG.RangeOp):
            c = layers[op.input]
            r = np.linalg.norm(c.xyz, axis=1)
            lo, hi = _f(op.range_min(env)), _f(op.range_max(env))
            m = (r >= lo) & (r <= hi)
            if op.between:
                layers[op.between] = Cloud(c.xyz[m], c.time[m])
            if op.outside:
                layers[op.outside] = Cloud(c.xyz[~m], c.time[~m])
        elif isinstance(op, FG.BBoxOp):
            c = layers[op.input]
            mn = np.array([_f(e(env)) for e in op.bb_min])
            mx = np.array([_f(e(env)) for e in op.bb_max])
            m = np.all((c.xyz >= mn) & (c.xyz <= mx), axis=1)
            if op.inside:
                layers[op.inside] = Cloud(c.xyz[m], c.time[m])
            if op.outside:
                layers[op.outside] = Cloud(c.xyz[~m], c.time[~m])
        elif isinstance(op, FG.DeskewOp):
            c = layers[op.input]
            if op.skip:
                layers[op.output] = Cloud(c.xyz.copy(), c.time.copy())
            else:
                tw = np.array([_f(env[v]) for v in op.twist_vars])
                layers[op.output] = _deskew(c, tw)
        elif isinstance(op, FG.DeleteOp):
            for name in op.layers_to_remove:
                layers.pop(name, None)
        else:
            raise ValueError(f"exact filters: unsupported pipeline op {type(op).__name__}")
    return layers
