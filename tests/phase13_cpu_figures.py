"""The CPU figures that ``chip_smoke.py``'s phase 13 holds the card to.

    PYTHONPATH=. python tests/phase13_cpu_figures.py port-multi-lidar
    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/phase13_cpu_figures.py jax-multi-lidar
    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/phase13_cpu_figures.py jax-cross <pipeline yaml> [--frames 12] [--cpu-defaults]
    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/phase13_cpu_figures.py jax-fork <pipeline yaml> --frames <k+1>

Each prints one JSON line.

``port-multi-lidar`` and ``jax-multi-lidar``: phase 13 (d), the multi-LiDAR
grouping (``apps/multi_lidar.py``: lidar3d-default with ``MOLA_LIDAR_COUNT=2``
through the async runtime, each of the bench's first 8 scans split by azimuth
half into two labelled sensors stamped 5 ms apart) at ``chip_smoke.SIZING``,
through the port with ``device="cpu"`` (no JAX in the process;
``chip_smoke.MULTI_LIDAR_CPU``) or through the JAX package's
``LidarOdometry`` and ``utils/runtime.py`` with the knobs of its TPU
algorithm (``chip_smoke.MULTI_LIDAR_JAX``).

``jax-cross``: phase 13 (c), one pipeline of ``eval/cross_pipeline.py``
driven as that script drives it (the same sequence, ``CAPS``, feed and
float32 error), with the knobs in :data:`KNOBS` that make the JAX package
run the algorithm the port runs (``--cpu-defaults`` leaves them unset, as
the plain script does).  Beside the script's figures it gives each frame's
error in float64 from the JAX poses (``apps/cross_pipeline.gt_error_f64``),
which ``chip_smoke.CROSS_PIPELINE_JAX`` holds.

``jax-fork``: where the full-voxel run (the port with ``per_voxel_nn`` off,
the JAX package at its CPU defaults) parts from the JAX figures, whose fork
is it?  Both packages' fleet steps (B = 1, ``CAPS``, the same sequence, the
port on the CPU) step frames 0..k-1 each from its own carry, and at every
frame the port also steps from the JAX package's carry of the frame before.
At frame k the JAX package also steps from the port's own carry
(``chip_smoke.CROSS_FULL_VOXEL_FRAMES_APART`` cites the figures).
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, ".."))

# The JAX package's TPU algorithm on a CPU: the fused path with the Pallas
# kernels in interpret mode for the pipelines the port aligns on kernel B3,
# the per-voxel capture and the XLA twin of the planar select for the
# pipelines that run the generic loop on kernel B4.
FUSED = {"MOLA_TPU_PALLAS": "1", "MOLA_TPU_PER_VOXEL_NN": "1", "MOLA_TPU_PALLAS_CAPTURE": "1"}
GENERIC = {"MOLA_TPU_PALLAS": "0", "MOLA_TPU_PER_VOXEL_NN": "1"}
KNOBS = {
    "lidar3d-default.yaml": FUSED, "extras/lidar3d-kissicp-like.yaml": FUSED,
    "lidar3d-ndt.yaml": GENERIC, "rgbd.yaml": GENERIC, "extras/lidar3d-dual-map.yaml": GENERIC,
    "extras/lidar3d-near-far.yaml": GENERIC, "extras/lidar3d-edges.yaml": GENERIC,
    "extras/lidar3d-intensity.yaml": GENERIC,
}


def port_multi_lidar():
    import chip_smoke
    from mola_lidar_odometry_tpu_torch.apps import bench_sequence as bs, multi_lidar as ml

    scans, traj = bs.gen_scans(chip_smoke.N_SCANS)
    return ml.run("cpu", scans, traj, chip_smoke.SIZING)


def jax_multi_lidar():
    os.environ.update(FUSED)
    import chip_smoke
    from mola_lidar_odometry_tpu.models.odometry import LidarOdometry
    from mola_lidar_odometry_tpu.utils import runtime
    from mola_lidar_odometry_tpu_torch.apps import bench_sequence as bs, cross_pipeline as cp, multi_lidar as ml

    scans, traj = bs.gen_scans(chip_smoke.N_SCANS)
    lo = LidarOdometry.from_yaml_file(os.path.join(cp.ROOT, ml.PIPELINE), env={"MOLA_LIDAR_COUNT": "2"},
                                      **chip_smoke.SIZING)
    assert lo.spec.multiple_lidar_count == 2
    r = ml.feed(lo, runtime, scans, traj)
    r["knobs"] = FUSED
    return r


def jax_cross(name: str, frames: int, cpu_defaults: bool):
    knobs = {} if cpu_defaults else KNOBS[name]
    os.environ.update(knobs)
    import jax.numpy as jnp

    from mola_lidar_odometry_tpu.models.odometry import LidarOdometry
    from mola_lidar_odometry_tpu.ops import se3
    from mola_lidar_odometry_tpu_torch.apps import bench_sequence as bs, cross_pipeline as cp

    scans, traj = bs.gen_scans(frames, workers=2)
    intens = bs.scan_intensities(scans)
    lo = LidarOdometry.from_yaml_file(os.path.join(cp.ROOT, name), **cp.CAPS)
    G0 = se3.Pose(jnp.asarray(traj.R[0], jnp.float32), jnp.asarray(traj.t[0], jnp.float32))
    errs, errs64, quals, iters = [], [], [], []
    for k, (xyz, times, rings, valid) in enumerate(scans):
        out = lo.on_lidar_scan(xyz[valid], float(traj.stamps[k]), times=times[valid], ring=rings[valid],
                               intensity=intens[k][valid])
        Gk = se3.Pose(jnp.asarray(traj.R[k], jnp.float32), jnp.asarray(traj.t[k], jnp.float32))
        errs.append(float(jnp.linalg.norm(se3.se3_log(se3.relative(se3.relative(G0, Gk),
                                                                   se3.Pose(out.pose_R, out.pose_t))))))
        errs64.append(cp.gt_error_f64(traj, k, out.pose_R, out.pose_t))
        quals.append(float(out.quality))
        iters.append(int(out.iterations))
        print(f"  {name} f{k}: q={quals[-1]:.3f} iters={iters[-1]} err={errs[-1]:.4f} (float64 {errs64[-1]:.4f})",
              file=sys.stderr, flush=True)
    return dict(name=name, knobs=knobs, worst=max(errs), errors=errs, worst_f64=max(errs64), errors_f64=errs64,
                quality=quals, iterations=iters)


def jax_fork(name: str, frames: int):
    os.environ.update({"MOLA_TPU_PALLAS": "0", "MOLA_TPU_PER_VOXEL_NN": "0"})
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.tree_util import DictKey, FlattenedIndexKey, GetAttrKey, tree_map_with_path

    from mola_lidar_odometry_tpu.models.spec import spec_from_yaml as jspec_from
    from mola_lidar_odometry_tpu.parallel import batch as jpb
    from mola_lidar_odometry_tpu.utils.config import load_yaml_file as jload
    from mola_lidar_odometry_tpu_torch.apps import bench_sequence as bs, cross_pipeline as cp
    from mola_lidar_odometry_tpu_torch.models.spec import spec_from_yaml as tspec_from
    from mola_lidar_odometry_tpu_torch.parallel import batch as tpb
    from mola_lidar_odometry_tpu_torch.utils import carry_io
    from mola_lidar_odometry_tpu_torch.utils.config import load_yaml_file as tload

    def jax_carry_from(jc, pc):
        """The JAX carry ``jc``'s structure with the leaves of the port's numpy carry ``pc``."""
        def leaf(path, like):
            x = pc
            for k in path:
                if isinstance(k, GetAttrKey):
                    x = getattr(x, k.name)
                elif isinstance(k, DictKey):
                    x = x[k.key]
                else:  # a point map's flattened leaves
                    assert isinstance(k, FlattenedIndexKey)
                    x = getattr(x, ("voxel_size", "data", "epoch")[k.key])
            return jnp.asarray(np.asarray(x, like.dtype).reshape(like.shape))
        return tree_map_with_path(leaf, jc)

    scans, traj = bs.gen_scans(frames, workers=2)
    path = os.path.join(cp.ROOT, name)
    js = jspec_from(jload(path, env={}), **cp.CAPS)
    ts = tspec_from(tload(path, env={}), per_voxel_nn=False, **cp.CAPS)
    assert not (js.icp_with_vel.per_voxel_nn or js.icp_with_vel.use_pallas)
    jstep, tstep = jax.jit(jpb.make_fleet_step(js)), tpb.make_fleet_step(ts)
    jc, tc = jpb.init_fleet_carry(js, 1), tpb.init_fleet_carry(ts, 1, device="cpu")
    rows = []
    for k, scan in enumerate(scans):
        jin, tin = jpb.pack_scans(js, [scan], [traj.stamps[k]]), tpb.pack_scans(ts, [scan], [traj.stamps[k]], device="cpu")
        if k == frames - 1:  # the JAX package from the port's own carry
            _, jo_p = jstep(jax_carry_from(jc, carry_io.carry_to_numpy(tc)), jin)
        jnum = jax.tree_util.tree_map(np.asarray, jc)
        _, to_j = tstep(carry_io.carry_from_numpy(jnum, device="cpu"), tin)
        pc = carry_io.carry_to_numpy(tc)
        jc, jo = jstep(jc, jin)
        tc, to = tstep(tc, tin)
        rows.append(dict(frame=k, iterations_jax=int(jo.iterations[0]), iterations_port=int(to.iterations[0]),
                         iterations_port_from_jax_carry=int(to_j.iterations[0]),
                         t_port_from_jax_carry_vs_jax=float(np.abs(to_j.pose_t.numpy() - np.asarray(jo.pose_t)).max()),
                         t_port_vs_jax=float(np.abs(to.pose_t.numpy() - np.asarray(jo.pose_t)).max()),
                         carry_t_before=float(np.abs(pc.pose_t - jnum.pose_t).max())))
        print(name, rows[-1], file=sys.stderr, flush=True)
    fork = dict(iterations_jax_from_port_carry=int(jo_p.iterations[0]),
                t_jax_from_port_carry_vs_port=float(np.abs(np.asarray(jo_p.pose_t) - to.pose_t.numpy()).max()))
    return dict(name=name, frames=rows, fork=fork)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=("port-multi-lidar", "jax-multi-lidar", "jax-cross", "jax-fork"))
    ap.add_argument("pipeline", nargs="?")
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--cpu-defaults", action="store_true")
    args = ap.parse_args()
    t0 = time.time()
    if args.mode == "port-multi-lidar":
        r = port_multi_lidar()
    elif args.mode == "jax-multi-lidar":
        r = jax_multi_lidar()
    elif args.mode == "jax-fork":
        r = jax_fork(args.pipeline, args.frames)
    else:
        r = jax_cross(args.pipeline, args.frames, args.cpu_defaults)
    r["wall_s"] = time.time() - t0
    print(json.dumps(r))


if __name__ == "__main__":
    main()
