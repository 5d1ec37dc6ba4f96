"""Host time to issue a fleet step: from the step's call to its return,
before the readback, over the whole window's steps."""


def read(r):
    return 1e3 * r.window.issue_s / r.window.steps
