"""Host ms a step in the fleet step's own work: its ``step`` span less the
``filters``, ``icp`` and ``map`` spans inside it (the gate, sigma,
keyframes, the whole-carry selects, the navstate prior; ``harness/spans.py``,
pass (a) of the traced stretch's steps, no torch.profiler)."""

from port_bench.harness import spans


def read(r):
    s = spans.of(r)
    return None if s is None else spans.host_ms(s)["step"]
