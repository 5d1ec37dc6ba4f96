"""ICP iterations a scan (``StepOutput.iterations``), the mean over every
scan of the window, frame 0's included."""


def read(r):
    return float(r.column("iterations").mean())
