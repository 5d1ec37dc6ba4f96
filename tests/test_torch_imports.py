"""The port imports neither JAX nor the JAX package.

Every module of mola_lidar_odometry_tpu_torch is imported in a fresh
interpreter; afterwards no ``sys.modules`` key may be ``jax`` or
``mola_lidar_odometry_tpu`` or lie below either (whole dotted names: the
port's own name has the JAX package's name as a string prefix).  The
package's public surface is the JAX package's, loaded lazily: importing the
package alone imports no torch, and each name resolves to the port's
object.  The one-line map wrappers the JAX package's users call exist in
the port's map modules too."""

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
        "models.odometry", "utils.runtime", "utils.capacity", "utils.exact_filters", "utils.serialization",
        "utils.profiler", "ops.ndt", "ops.occupancy", "utils.mrpt_io", "utils.native", "utils.rosbag2",
        "utils.mcap", "utils.icp_log", "utils.viz", "utils.live_viz", "apps.datasets", "apps.cli", "apps.convert",
        "apps.launcher", "apps.icplog_viewer", "apps.ros2_bridge", "oracle", "apps.fleet_eval",
        "parallel.fleet_probe", "parallel.point_axis", "parallel.dryrun", "apps.bench_sequence", "apps.trace_step",
        "apps.profile_stages", "apps.cross_pipeline", "apps.multi_lidar", "utils.tree",
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
    assert "mola_lidar_odometry_tpu_torch.models.odometry" in loaded


def test_lazy_public_surface():
    """The JAX package's lazy exports (its ``__init__.py``), in the port:
    the same names, importing the package pulls in no torch, and each name
    resolves to the port's own object."""
    import mola_lidar_odometry_tpu as jax_pkg

    assert port.__all__ == jax_pkg.__all__
    code = (
        "import json, sys\n"
        "import mola_lidar_odometry_tpu_torch as p\n"
        "before = 'torch' in sys.modules\n"
        "mods = {n: getattr(p, n).__module__ for n in p.__all__}\n"
        "print(json.dumps([before, mods]))\n"
    )
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    torch_before, mods = json.loads(res.stdout.strip().splitlines()[-1])
    assert not torch_before
    assert mods == {
        "LidarOdometry": "mola_lidar_odometry_tpu_torch.models.odometry",
        "OdometrySpec": "mola_lidar_odometry_tpu_torch.models.spec",
        "spec_from_yaml": "mola_lidar_odometry_tpu_torch.models.spec",
        "AsyncLidarOdometry": "mola_lidar_odometry_tpu_torch.utils.runtime",
        "Observation": "mola_lidar_odometry_tpu_torch.utils.runtime",
    }
    import pytest

    with pytest.raises(AttributeError):
        port.NoSuchName


def test_map_wrappers_exist_in_the_port():
    """``insert`` in every map module and the single-shot queries, as the
    JAX package names them."""
    import importlib

    for mod, names in (("ops.voxel_hash", ("insert", "query_nn", "query_nn2", "query_p2pl")),
                       ("ops.ndt", ("insert", "query_p2p", "query_p2pl")), ("ops.occupancy", ("insert",)),
                       ("ops.maps", ("insert",)), ("ops.solver", ("gauss_newton_step", "solve_gauss_newton"))):
        m = importlib.import_module(f"{port.__name__}.{mod}")
        missing = [n for n in names if not callable(getattr(m, n, None))]
        assert not missing, (mod, missing)
