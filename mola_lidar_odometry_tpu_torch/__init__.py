"""mola_lidar_odometry_tpu_torch — the PyTorch/CUDA port of mola_lidar_odometry_tpu.

The package mirrors the JAX package's layout (``ops/``, ``models/``,
``parallel/``, ``utils/``) module for module, so each file's counterpart is
found by name.  Differences that hold everywhere:

  * state is ``NamedTuple``s of tensors with an explicit leading fleet
    dimension ``B`` instead of ``vmap``;
  * entry points take a ``device`` argument that defaults to ``"cuda"``;
  * the JAX package's four Pallas kernels, on two paths (capture, reselect
    and the fused align on the lidar3d-default step; the nearest-candidate
    select on the generic align loop), are hand-written CUDA for Hopper
    (``csrc/``), each with a plain PyTorch twin in the same module that runs
    only for CPU tensors.

Nothing here imports ``jax`` or the JAX package.  The public surface is
the JAX package's, loaded lazily (importing the package imports no torch):

    from mola_lidar_odometry_tpu_torch import LidarOdometry
    lo = LidarOdometry.from_yaml_file("pipelines/lidar3d-default.yaml")
    out = lo.on_lidar_scan(xyz, stamp, times=times)
"""

__version__ = "0.1.0"

__all__ = [
    "LidarOdometry",
    "OdometrySpec",
    "spec_from_yaml",
    "AsyncLidarOdometry",
    "Observation",
]


def __getattr__(name):  # lazy: importing the package must not pull in torch
    if name == "LidarOdometry":
        from mola_lidar_odometry_tpu_torch.models.odometry import LidarOdometry

        return LidarOdometry
    if name in ("OdometrySpec", "spec_from_yaml"):
        from mola_lidar_odometry_tpu_torch.models import spec as _spec

        return getattr(_spec, name)
    if name in ("AsyncLidarOdometry", "Observation"):
        from mola_lidar_odometry_tpu_torch.utils import runtime as _rt

        return getattr(_rt, name)
    raise AttributeError(name)
