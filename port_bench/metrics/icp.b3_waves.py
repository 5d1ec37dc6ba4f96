"""Waves a launch of kernel B3: the program's ``b3.waves`` counter (ceil of
the fleet over the clusters of the launch's shape that the card holds at
once, ``cudaOccupancyMaxActiveClusters``), the mean over the launches of
pass (a) of the traced stretch (``harness/spans.py``)."""

from port_bench.harness import spans


def read(r):
    s = spans.of(r)
    return None if s is None else spans.counter_mean(s, "b3.waves")
