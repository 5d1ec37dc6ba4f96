"""The work of the ICP layer's kernels, counted from the shapes the ICP
layer hands them and the iterations it runs, and the least time the card
could take for it.

The counts are ``chip_smoke.py``'s (``bound``, ``b3_bound``, B4's
``B*N*(16*C + 28)`` bytes), kept here so that the yardstick does not move
with the program, with one change: the capture (kernels B1 and B2) is
counted by what it must read and write whatever implements it (the queries
read, the candidate planes written), without the map rows a particular
kernel happens to fetch, which depend on the map's contents.  That makes
the capture's bound a lower one.

Bound = max(bytes / HBM bandwidth, float32 operations / float32 peak),
each input byte read once and each output byte written once; the peaks are
the H100 SXM data sheet's at its 700 W limit.
"""

from __future__ import annotations

import contextlib
import functools
from typing import List, Tuple

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_FLOPS = 67e12  # H100 SXM data sheet, float32 outside the tensor cores


def bound_ms(nbytes: float, flops: float) -> Tuple[float, str]:
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def align_work(B: int, n_points: int, C: int, npad: int, table_len: int, iterations: int, gn_inner: int):
    """One align (B3): the points (12 bytes and a valid byte each), the
    candidate planes, the two per-iteration threshold tables and the poses
    in and out; ~9 operations a candidate and 18 + 45 a Gauss-Newton pass
    per point over ``iterations`` (summed over the instances) plus one
    quality pass per instance."""
    nbytes = B * n_points * 13 + 4 * B * C * npad * 4 + 2 * B * table_len * 4 + B * 16 * 4
    return nbytes, (iterations + B) * npad * (C * 9 + 18 + gn_inner * 45)


def capture_work(B: int, n_points: int, probes: int, npad: int, reselect: bool):
    """One capture (B1) or reselect (B2): the queries read (the reselect
    reads two sets) and the planes of the top two candidates of every probe
    written; no operations counted."""
    q_bytes = B * n_points * 3 * 4 + B * n_points
    planes = 4 * B * 2 * probes * npad * 4
    return (2 if reselect else 1) * q_bytes + planes, 0


def select_work(B: int, n_points: int, C: int):
    """One nearest-candidate select (B4) over ``C`` candidates a query."""
    return B * n_points * (16 * C + 28), B * n_points * C * 9


# the kernels' names in a device trace, by the wrapper that launches them
KERNELS = {"align": "align_kernel", "capture": "capture_gather_kernel", "reselect": "reselect_kernel",
           "select": "nn_select_kernel"}


class Recorder:
    """Records each call of the port's kernel wrappers (their argument
    shapes, and the iterations each align returns) while it is entered;
    the wrappers are put back on exit.  A wrapper the program no longer
    has is not recorded."""

    def __init__(self):
        self.calls: List[tuple] = []
        self.complete = True  # False once a call's arguments were not the expected shapes

    @contextlib.contextmanager
    def __call__(self):
        from mola_lidar_odometry_tpu_torch.ops import pallas_capture, pallas_icp, pallas_match

        targets = [(pallas_icp, "align_fused", self._align), (pallas_capture, "capture_planar", self._capture),
                   (pallas_capture, "capture_planar_reselect", self._reselect),
                   (pallas_match, "nn_select", self._select)]
        saved = []
        for mod, name, rec in targets:
            fn = getattr(mod, name, None)
            if fn is None:
                continue
            wrapper = functools.wraps(fn)(rec(fn))  # with the wrapper's attributes (its launch counter)
            saved.append((mod, name, fn, wrapper))
            setattr(mod, name, wrapper)
        try:
            yield self
        finally:
            for mod, name, fn, wrapper in saved:
                fn.__dict__.update(wrapper.__dict__)
                setattr(mod, name, fn)

    def _align(self, fn):
        def wrapped(*args, **kw):
            out = fn(*args, **kw)
            try:
                B, C, npad = args[0][0].shape
                self.calls.append(("align", B, args[1].shape[1], C, npad, args[8].shape[-1], kw["gn_inner"], out[2]))
            except (AttributeError, IndexError, KeyError, TypeError, ValueError):
                self.complete = False
            return out
        return wrapped

    def _capture(self, fn):
        def wrapped(*args, **kw):
            out = fn(*args, **kw)
            try:
                self.calls.append(("capture", *args[3].shape[:2], int(args[4]), out[0].shape[-1]))
            except (AttributeError, IndexError, TypeError, ValueError):
                self.complete = False
            return out
        return wrapped

    def _reselect(self, fn):
        def wrapped(*args, **kw):
            out = fn(*args, **kw)
            try:
                self.calls.append(("reselect", *args[3].shape[:2], int(args[5]), out[0].shape[-1]))
            except (AttributeError, IndexError, TypeError, ValueError):
                self.complete = False
            return out
        return wrapped

    def _select(self, fn):
        def wrapped(planar, queries, *args, **kw):
            try:
                self.calls.append(("select", *planar.x.shape))
            except (AttributeError, TypeError, ValueError):
                self.complete = False
            return fn(planar, queries, *args, **kw)
        return wrapped

    def bound_ms_by_kind(self) -> dict:
        """The least time of the recorded calls, summed by kernel kind."""
        out = {}
        for call in self.calls:
            kind = call[0]
            if kind == "align":
                _, B, n, C, npad, table_len, gn_inner, iters = call
                w = align_work(B, n, C, npad, table_len, int(iters.sum()), gn_inner)
            elif kind == "select":
                w = select_work(*call[1:])
            else:
                _, B, n, P, npad = call
                w = capture_work(B, n, P, npad, kind == "reselect")
            out[kind] = out.get(kind, 0.0) + bound_ms(*w)[0]
        return out
