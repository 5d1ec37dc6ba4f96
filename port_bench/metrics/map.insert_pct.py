"""Share of the window's instance-steps whose scan went into the local map
(``StepOutput.kf_local``); the step runs its masked insert on every one."""


def read(r):
    return 100.0 * float(r.column("kf_local").mean())
