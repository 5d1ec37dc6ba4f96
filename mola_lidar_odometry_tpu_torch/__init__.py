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

Nothing here imports ``jax`` or the JAX package.
"""

__version__ = "0.1.0"
