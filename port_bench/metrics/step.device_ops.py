"""Device ops a traced step runs (kernels, copies and sets)."""


def read(r):
    if r.traced is None or not r.traced.events:
        return None
    return len(r.traced.events) / r.traced.steps
