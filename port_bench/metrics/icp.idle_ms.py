"""Device idle ms a step while the fleet step's `step.icp` span is open
on the host: the gaps of the device's busy union over pass (b) of the
traced stretch (a device-only trace), split by the span open innermost on
the host (`harness/spans.py`)."""

from port_bench.harness import spans


def read(r):
    s = spans.of(r)
    idle = None if s is None else spans.idle_ms(s)
    return None if idle is None else idle["icp"]
