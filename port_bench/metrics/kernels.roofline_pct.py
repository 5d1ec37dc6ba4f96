"""The ICP kernels' share of their roofline over the traced steps: the sum
of the recorded calls' bound times (``harness/work.py``, from the shapes
the ICP layer hands them and the iterations they ran) over the sum of the
device times of those kernels' events."""

from port_bench.harness.work import KERNELS


def read(r):
    t = r.traced
    if t is None or not t.recorder.complete or not t.recorder.calls:
        return None
    bound = t.recorder.bound_ms_by_kind()
    names = {kind: KERNELS[kind] for kind in bound}
    spent_us = sum(e - s for s, e, name, _ in t.events if any(k in name for k in names.values()))
    if spent_us <= 0:
        return None
    return 100.0 * sum(bound.values()) / (spent_us * 1e-3)
