"""Host ms a step in the fleet step's `step.icp` span (the port's own
span; `harness/spans.py`, pass (a) of the traced stretch's steps, no
torch.profiler), the waits of its host syncs in."""

from port_bench.harness import spans


def read(r):
    s = spans.of(r)
    return None if s is None else spans.host_ms(s)["icp"]
