"""Device ms a traced step of the ops the local map launches (insert,
prune)."""

from port_bench.harness.readings import device_ms_per_step

MODULES = ("ops/voxel_hash.py", "ops/maps.py")


def read(r):
    return device_ms_per_step(r, MODULES)
