"""The port imports neither JAX nor the JAX package.

Every module of mola_lidar_odometry_tpu_torch is imported in a fresh
interpreter; afterwards no ``sys.modules`` key may be ``jax`` or
``mola_lidar_odometry_tpu`` or lie below either (whole dotted names: the
port's own name has the JAX package's name as a string prefix)."""

import json
import os
import pkgutil
import subprocess
import sys

import mola_lidar_odometry_tpu_torch as port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_modules():
    names = [port.__name__]
    for info in pkgutil.walk_packages(port.__path__, prefix=port.__name__ + "."):
        names.append(info.name)
    return names


def test_every_port_module_is_listed():
    mods = _port_modules()
    for expected in (
        "ops.se3", "ops.filters", "ops.voxel_hash", "ops.pallas_capture", "ops.pallas_icp",
        "ops.pallas_match", "ops.solver", "ops.maps", "ops.icp", "models.step", "parallel.batch", "utils.carry_io", "utils.sim",
    ):
        assert f"{port.__name__}.{expected}" in mods


def test_port_imports_no_jax():
    code = (
        "import importlib, json, sys\n"
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=300
    )
    assert res.returncode == 0, res.stderr
    loaded = json.loads(res.stdout.strip().splitlines()[-1])
    banned = [
        m for m in loaded
        if m in ("jax", "mola_lidar_odometry_tpu")
        or m.startswith("jax.")
        or m.startswith("mola_lidar_odometry_tpu.")
    ]
    assert not banned, banned
    assert "mola_lidar_odometry_tpu_torch.models.step" in loaded
