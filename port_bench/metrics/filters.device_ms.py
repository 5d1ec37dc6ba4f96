"""Device ms a traced step of the ops the filter layer launches."""

from port_bench.harness.readings import device_ms_per_step

MODULES = ("models/filter_graph.py", "ops/filters.py", "ops/pointcloud.py")


def read(r):
    return device_ms_per_step(r, MODULES)
