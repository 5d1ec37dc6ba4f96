"""Blocking reads of a device value a step on the fleet step's path: the
program's ``host_syncs`` counter over pass (a) of the traced stretch
(``harness/spans.py``) over its steps.  The harness's own readback is not
in the program and is not counted."""

from port_bench.harness import spans


def read(r):
    s = spans.of(r)
    return None if s is None else spans.counter_per_step(s, "host_syncs")
