"""Peak device memory over the window (``max_memory_allocated`` after
``reset_peak_memory_stats`` at its start), the cell's scans included."""


def read(r):
    return r.window.peak_bytes / 1e9 if r.window.peak_bytes else None
