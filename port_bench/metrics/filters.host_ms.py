"""Host ms a step in the fleet step's `step.filters` span (the port's own
span; `harness/spans.py`, pass (a) of the traced stretch's steps, no
torch.profiler)."""

from port_bench.harness import spans


def read(r):
    s = spans.of(r)
    return None if s is None else spans.host_ms(s)["filters"]
