"""Whether what the timed path produced is correct.

Once the window has closed, the last episode it completed is judged, pose
by pose and instance by instance:

* a sample of its instances, drawn from the seed, is run again by the
  plain reference (``port_bench/reference``: float64 numpy, from the YAML
  and the same scans, nothing of the program), each in a worker process of
  its own; ``ref_gap_worst_m`` is the widest gap of any of their poses to
  the reference's;
* every pose of every instance is held against the generator's ground
  truth; ``fleet_gt_worst_m`` is the widest error, so a fault in any one
  slot of the fleet shows.

The numbers compared are those with a limit in the cell's settings file
(``cells/<cell>.json``), and ``correct`` holds when none is exceeded.  The
medians and the quality, layer-count and map-update differences are worked
out for the record.
"""

from __future__ import annotations

import concurrent.futures
import multiprocessing
import os
from typing import Dict, List, Sequence

import numpy as np

from port_bench.harness.accuracy import translation_errors
from port_bench.harness.program import COLUMNS


def sample_instances(seed: int, batch: int, n: int) -> List[int]:
    rng = np.random.default_rng([seed, 2])
    return sorted(int(i) for i in rng.choice(batch, size=min(n, batch), replace=False))


def run_reference(yaml_path: str, sequences: Dict[int, list], stamps: Sequence[float], registration: bool = True):
    """The reference over each instance's scans, one spawned process per
    instance with one compute thread (numpy only; each waited for):
    instance -> its outputs."""
    from port_bench.reference.oracle import run_sequence

    ctx = multiprocessing.get_context("spawn")
    keys = sorted(sequences)
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"  # read by the workers' numpy, not by this process's, loaded already
    with concurrent.futures.ProcessPoolExecutor(len(keys), mp_context=ctx) as pool:
        futs = {i: pool.submit(run_sequence, yaml_path, sequences[i], list(stamps), registration) for i in keys}
        return {i: futs[i].result() for i in keys}


def numbers(episode: np.ndarray, ref: Dict[int, list], trajs) -> Dict[str, float]:
    """The numbers from one episode's rows ``(F, B, columns)`` and the
    reference's outputs of the sampled instances: the widest gap of a
    sampled pose to the reference's and the widest error of any pose
    against the ground truth (compared), and, for the record, the medians
    over instances of each one's RMS gap and RMS error, and the widest
    quality, layer-count and map-update differences."""
    gaps, pose_gap, quality_gap, layer_gap, mismatch = [], 0.0, 0.0, 0.0, 0
    for i, outs in ref.items():
        rows = episode[:, i]
        d = np.array([np.linalg.norm(rows[k, COLUMNS["t"]].astype(np.float64) - o.t) for k, o in enumerate(outs)])
        gaps.append(float(np.sqrt(np.mean(d * d))))
        pose_gap = max(pose_gap, float(d.max()))
        for k, o in enumerate(outs):
            r = rows[k]
            if k > 0:
                quality_gap = max(quality_gap, abs(float(r[COLUMNS["quality"]][0]) - o.quality))
            for col, n_ref in (("n_icp_layer", o.n_icp_layer), ("n_map_layer", o.n_map_layer)):
                layer_gap = max(layer_gap, abs(float(r[COLUMNS[col]][0]) - n_ref) / max(n_ref, 1))
            mismatch += int(bool(r[COLUMNS["kf_local"]][0] > 0.5) != bool(o.kf_local))
    err = translation_errors(episode, trajs)  # (F, B)
    return dict(ref_gap_worst_m=pose_gap, fleet_gt_worst_m=float(err.max()),
                ref_gap_median_m=float(np.median(gaps)),
                fleet_ate_median_m=float(np.median(np.sqrt(np.mean(err * err, axis=0)))),
                worst_instance=float(np.argmax(err.max(axis=0))), quality_gap=quality_gap, layer_gap=layer_gap,
                keyframe_mismatch=float(mismatch))


def judge(found: Dict[str, float], limits: Dict[str, float]):
    """``(correct, [(name, number, limit)])`` over the numbers the cell has
    limits for; a number that is missing or not finite fails."""
    lines = []
    ok = True
    for name, lim in limits.items():
        v = found.get(name, float("nan"))
        ok &= bool(np.isfinite(v) and v <= lim)
        lines.append((name, v, lim))
    return ok, lines
