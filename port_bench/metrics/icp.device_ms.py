"""Device ms a traced step of the ops the ICP layer launches (its kernels
B1-B4 among them)."""

from port_bench.harness.readings import device_ms_per_step

MODULES = ("ops/icp.py", "ops/solver.py", "ops/se3.py", "ops/pallas_capture.py", "ops/pallas_icp.py",
           "ops/pallas_match.py")


def read(r):
    return device_ms_per_step(r, MODULES)
