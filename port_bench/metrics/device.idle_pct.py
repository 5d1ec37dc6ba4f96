"""Share of a stretch of steps in which no op ran on the device: the
device's busy time (the union of its ops, traced without stacks) against
the same steps' time untraced on the host clock.  Even without stacks the
profiler slows the host's issue of ~1800 launches a step by about a
quarter, which the trace's own span would count as idle."""


def read(r):
    t = r.timeline
    if t is None or not t.events or t.untraced_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.untraced_s)
