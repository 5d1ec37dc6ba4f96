"""Pose errors against the generator's ground truth, in float64 on the host.

The gauge is that of the port's ``apps/cross_pipeline.py::gt_error_f64``:
both the estimate and the ground truth are taken relative to their own
frame 0, and the error of frame ``k`` is the translation of
``gt_rel_k^-1 est_rel_k``.
"""

from __future__ import annotations

import numpy as np

from port_bench.harness.program import COLUMNS


def translation_errors(rows: np.ndarray, trajs) -> np.ndarray:
    """``rows`` ``(..., F, B, columns)`` of one or more episodes -> the
    translation errors ``(..., F, B)`` in metres."""
    R = rows[..., COLUMNS["R"]].astype(np.float64).reshape(rows.shape[:-1] + (3, 3))
    t = rows[..., COLUMNS["t"]].astype(np.float64)
    R0, t0 = R[..., :1, :, :, :], t[..., :1, :, :]
    est = np.einsum("...ji,...j->...i", R0, t - t0)  # R0^T (t_k - t0)
    gR0 = np.stack([tr.R[0] for tr in trajs])  # (B, 3, 3)
    gt = np.stack([tr.t for tr in trajs], axis=1)  # (F, B, 3)
    gt_rel = np.einsum("bji,fbj->fbi", gR0, gt - gt[:1])
    return np.linalg.norm(est - gt_rel, axis=-1)


def ate_rmse(rows: np.ndarray, trajs) -> float:
    """RMS of every frame's translation error, over every instance and
    every episode in ``rows`` ``(E, F, B, columns)``."""
    e = translation_errors(rows, trajs)
    return float(np.sqrt(np.mean(e * e)))
