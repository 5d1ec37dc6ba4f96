"""mola-lidar-odometry-cli — offline odometry runs over dataset inputs.

TPU-framework counterpart of the reference CLI application
(reference apps/mola-lidar-odometry-cli.cpp:84-161 flags, :344-545 run
loop): pick ONE input dataset, run the configured odometry pipeline over it
with progress/ETA reporting, and write the TUM trajectory / simplemap
outputs.  CLI flags supersede YAML pipeline values
(apps/mola-lidar-odometry-cli.cpp:391-399).

Port of ``mola_lidar_odometry_tpu/apps/cli.py``: the same flags, plus
``--device`` (the card unless ``cpu`` is given).  The capacities follow
``LidarOdometry.from_yaml_file``'s policy: ``--raw-capacity`` or
``--map-slots`` (or ``MOLA_TPU_RAW_CAPACITY`` / ``MOLA_TPU_MAP_SLOTS`` in
the environment) pin them, the other one taking the JAX CLI's default
(131072 raw points, 262144 map slots); with none of them every buffer and
the map's insert budget are derived from the first scan
(``utils/capacity.py``).  ``--per-voxel-nn``, ``--nn-neighbors``,
``--icp-anderson``, ``--fused-align``, ``--capture-kernel``,
``--phase1-neighbors``, ``--refresh-reselect``, ``--refresh-neighbors`` and
``--fused-refresh`` set the ICP knobs the JAX CLI reads from
``MOLA_TPU_PER_VOXEL_NN``, ``MOLA_TPU_NN_NEIGHBORS``,
``MOLA_TPU_ICP_ANDERSON``, ``MOLA_TPU_PALLAS``, ``MOLA_TPU_PALLAS_CAPTURE``,
``MOLA_TPU_PHASE1_NEIGHBORS``, ``MOLA_TPU_REFRESH_RESELECT``,
``MOLA_TPU_REFRESH_NEIGHBORS`` and ``MOLA_TPU_FUSED_REFRESH``; unset, each
flag takes its variable's value, so the same environment gives both CLIs
the same algorithm.

Usage:
    python -m mola_lidar_odometry_tpu_torch.apps.cli \
        -c pipelines/lidar3d-default.yaml \
        --input-kitti-seq 00 \
        --output-tum-path results/kitti_00.tum
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="mola-lidar-odometry-cli",
        description="LiDAR odometry (PyTorch/CUDA engine) over an offline dataset",
    )
    p.add_argument("-c", "--config", required=True, help="pipeline YAML file")
    p.add_argument("-v", "--verbosity", default="INFO",
                   choices=["ERROR", "WARN", "INFO", "DEBUG"])
    p.add_argument("--output-tum-path", default=None,
                   help="save the estimated trajectory in TUM format")
    p.add_argument("--output-simplemap", default=None,
                   help="build and save the simplemap of the mapping session")
    p.add_argument("--output-local-map", default=None,
                   help="save the final local metric map (.mm.npz)")
    p.add_argument("--only-first-n", type=int, default=0,
                   help="run only the first N dataset entries")
    p.add_argument("--skip-first-n", type=int, default=0,
                   help="skip the first N dataset entries")
    p.add_argument("--lidar-sensor-label", default=None,
                   help="supersedes lidar_sensor_labels in the pipeline YAML")
    p.add_argument("--load-local-map", default=None,
                   help="preload an existing local map (multi-session)")
    p.add_argument("--viz-snapshot", default=None,
                   help="render a top-down PNG snapshot at the end of the run")
    p.add_argument("--live-viz", type=int, default=None, metavar="PORT",
                   help="serve a live self-refreshing view (map snapshot, "
                        "stats, pause/resume/save controls) on this port "
                        "(the reference GUI's HTTP analogue; 0 = any port)")
    p.add_argument("--live-viz-every", type=int, default=10,
                   help="re-render the live snapshot every N frames")
    p.add_argument("--device", default="cuda",
                   help="where the odometry runs: cuda (the default; raises without a card) or cpu")

    # input datasets (exactly one)
    g = p.add_argument_group("input dataset (choose one)")
    g.add_argument("--input-kitti-seq", default=None, metavar="00",
                   help="KITTI odometry sequence number ($KITTI_BASE_DIR)")
    g.add_argument("--kitti-correction-angle-deg", type=float, default=0.205,
                   help="vertical angle correction (Deschaud, 2018)")
    g.add_argument("--input-kitti360-seq", default=None, metavar="00",
                   help="KITTI-360 sequence ($KITTI360_DATASET)")
    g.add_argument("--input-mulran-seq", default=None, metavar="KAIST01",
                   help="MulRan sequence ($MULRAN_BASE_DIR)")
    g.add_argument("--input-paris-luco", action="store_true",
                   help="Paris-LuCo dataset ($PARIS_LUCO_BASE_DIR)")
    g.add_argument("--input-rawlog", default=None, help="MRPT .rawlog file")
    g.add_argument("--input-rosbag2", default=None, help="rosbag2 .mcap/.db3")
    g.add_argument("--input-sim", type=int, default=None, metavar="N",
                   help="bundled simulator, N frames (always available)")
    g.add_argument("--sim-seed", type=int, default=0)

    # engine capacities (static buffer shapes)
    e = p.add_argument_group("engine")
    e.add_argument("--raw-capacity", type=int, default=os.environ.get("MOLA_TPU_RAW_CAPACITY"),
                   help="raw points per scan (default 131072 when --map-slots is given, else derived)")
    e.add_argument("--map-slots", type=int, default=os.environ.get("MOLA_TPU_MAP_SLOTS"),
                   help="local-map hash slots (default 262144 when --raw-capacity is given, else derived)")
    # the JAX package's ICP knobs (its MOLA_TPU_* variables), on both ICP blocks
    e.add_argument("--per-voxel-nn", type=int, choices=(0, 1), default=os.environ.get("MOLA_TPU_PER_VOXEL_NN"),
                   help="1: capture the two points of each probed voxel nearest the query (the default); "
                        "0: every point of each probed voxel, the generic ICP loop (the JAX package's CPU default)")
    e.add_argument("--nn-neighbors", type=int, default=os.environ.get("MOLA_TPU_NN_NEIGHBORS"),
                   help="voxels probed per query: 8 (nearest 2x2x2) or 27 (3x3x3); default 8 for single-matcher "
                        "pipelines, 27 for the others")
    e.add_argument("--icp-anderson", type=int, default=os.environ.get("MOLA_TPU_ICP_ANDERSON"),
                   help="Anderson acceleration depth of the ICP loop (0 = off, the default)")
    # the fused align's switches (the JAX package's A/B variables)
    e.add_argument("--fused-align", type=int, choices=(0, 1), default=os.environ.get("MOLA_TPU_PALLAS"),
                   help="1: the fused two-phase align where the ICP block allows it (the default); 0: the generic "
                        "ICP loop over the same candidates")
    e.add_argument("--capture-kernel", type=int, choices=(0, 1), default=os.environ.get("MOLA_TPU_PALLAS_CAPTURE"),
                   help="1: the fused align captures with its kernel up to 126 points per voxel (the default); 0: "
                        "with the plain per-voxel capture, refreshed by a fresh capture")
    e.add_argument("--phase1-neighbors", type=int, default=os.environ.get("MOLA_TPU_PHASE1_NEIGHBORS"),
                   help="voxels probed by the fused align's first capture (1, 4, 8 or 27; default all of "
                        "--nn-neighbors)")
    e.add_argument("--refresh-reselect", type=int, choices=(0, 1), default=os.environ.get("MOLA_TPU_REFRESH_RESELECT"),
                   help="1: the fused align's refresh re-ranks the first capture's rows (the default); 0: a fresh "
                        "capture at the settled pose")
    e.add_argument("--refresh-neighbors", type=int, default=os.environ.get("MOLA_TPU_REFRESH_NEIGHBORS"),
                   help="voxels probed by a fresh refresh (default 4 when the first capture probes 8, else as many)")
    e.add_argument("--fused-refresh", type=int, choices=(0, 1), default=os.environ.get("MOLA_TPU_FUSED_REFRESH"),
                   help="1: the fused align refreshes its candidates after 8 iterations (the default); 0: one phase")
    return p


SWITCHES = ("per_voxel_nn", "fused_align", "capture_kernel", "refresh_reselect", "fused_refresh")  # the 0/1 flags


def icp_overrides(args) -> dict:
    """The ICP knobs given (by flag or environment) as ``spec_from_yaml``
    overrides."""
    from mola_lidar_odometry_tpu_torch.models.spec import ICP_KNOBS

    knobs = {k: getattr(args, "icp_anderson" if k == "anderson_m" else k) for k in ICP_KNOBS}
    return {k: bool(v) if k in SWITCHES else v for k, v in knobs.items() if v is not None}


def make_dataset(args):
    from mola_lidar_odometry_tpu_torch.apps import datasets as D

    chosen = [
        args.input_kitti_seq is not None,
        args.input_kitti360_seq is not None,
        args.input_mulran_seq is not None,
        args.input_paris_luco,
        args.input_rawlog is not None,
        args.input_rosbag2 is not None,
        args.input_sim is not None,
    ]
    if sum(chosen) != 1:
        raise SystemExit("error: exactly one --input-* dataset must be given")
    if args.input_kitti_seq is not None:
        return D.KittiOdometryDataset(
            args.input_kitti_seq,
            vertical_angle_correction_deg=args.kitti_correction_angle_deg,
        )
    if args.input_kitti360_seq is not None:
        return D.Kitti360Dataset(args.input_kitti360_seq)
    if args.input_mulran_seq is not None:
        return D.MulranDataset(args.input_mulran_seq)
    if args.input_paris_luco:
        return D.ParisLucoDataset()
    if args.input_rawlog is not None:
        return D.RawlogDataset(args.input_rawlog)
    if args.input_rosbag2 is not None:
        return D.Rosbag2Dataset(args.input_rosbag2)
    return D.SimDataset(args.input_sim, seed=args.sim_seed)


def main(argv=None) -> int:
    run(argv)
    return 0


def run(argv=None):
    """The CLI's run (what :func:`main` does); returns the LidarOdometry."""
    args = build_parser().parse_args(argv)

    from mola_lidar_odometry_tpu_torch.models.odometry import LidarOdometry
    from mola_lidar_odometry_tpu_torch.utils import tum

    dataset = make_dataset(args)

    overrides = {}
    if args.lidar_sensor_label:
        overrides["lidar_sensor_labels"] = (args.lidar_sensor_label,)
    overrides.update(icp_overrides(args))

    from dataclasses import replace

    from mola_lidar_odometry_tpu_torch.models.spec import spec_from_yaml
    from mola_lidar_odometry_tpu_torch.utils.config import load_yaml_file

    cfg = load_yaml_file(args.config)
    if args.raw_capacity is None and args.map_slots is None:
        # nothing pinned: the first scan's dry pass, as LidarOdometry's
        # auto-sizing makes it (before the map is built, so that
        # --load-local-map fills a map of the derived size)
        from mola_lidar_odometry_tpu_torch.utils.capacity import derive_capacities

        fr = dataset.get(args.skip_first_n)
        sizes = derive_capacities(spec_from_yaml(cfg, **overrides), fr.xyz, fr.times, with_budgets=True)
        overrides.update(zip(("raw_capacity", "map_slots", "layer_capacities", "insert_budgets"), sizes))
    else:
        overrides.update(raw_capacity=args.raw_capacity or 1 << 17, map_slots=args.map_slots or 1 << 18)
    spec = spec_from_yaml(cfg, **overrides)
    if args.output_simplemap:
        # CLI flag enables simplemap generation regardless of YAML
        # (reference apps/mola-lidar-odometry-cli.cpp:391-395)
        spec = replace(spec, simplemap=replace(spec.simplemap, generate=True))
    lo = LidarOdometry(spec, device=args.device)
    if args.load_local_map:
        lo.load_local_map(args.load_local_map)

    # GT export (reference apps/mola-lidar-odometry-cli.cpp:442-453)
    gt = dataset.ground_truth()
    if gt is not None and args.output_tum_path:
        gt_path = args.output_tum_path + ".gt.tum"
        tum.save_tum(gt_path, gt.stamps, gt.t, gt.quat_xyzw)
        print(f"Ground truth trajectory: {len(gt.stamps)} poses -> {gt_path}")

    viewer = None
    if args.live_viz is not None:
        from mola_lidar_odometry_tpu_torch.utils.live_viz import LiveViewer

        viewer = LiveViewer(lo, every_n=args.live_viz_every)
        port = viewer.start(port=args.live_viz)
        print(f"Live view: http://127.0.0.1:{port}/")

    n = len(dataset)
    first = args.skip_first_n
    last = min(n, first + args.only_first_n) if args.only_first_n else n
    t_start = time.time()
    for i in range(first, last):
        fr = dataset.get(i)
        lo.on_lidar_scan(
            fr.xyz, fr.stamp, times=fr.times, intensity=fr.intensity, ring=fr.ring,
            keep_scan_for_simplemap=bool(args.output_simplemap),
        )
        if viewer is not None:
            viewer.on_frame()
        if args.verbosity in ("INFO", "DEBUG") and (
            i == first or (i - first) % 20 == 19 or i + 1 == last
        ):
            done = i - first + 1
            rate = done / max(time.time() - t_start, 1e-9)
            eta = (last - i - 1) / max(rate, 1e-9)
            sys.stderr.write(
                f"\r[{done}/{last - first}] {100.0 * done / (last - first):5.1f}% "
                f"| {rate:6.2f} scans/s | ETA {eta:6.0f}s "
            )
            sys.stderr.flush()
    sys.stderr.write("\n")

    if args.output_tum_path:
        lo.save_trajectory_tum(args.output_tum_path)
        print(f"Estimated trajectory: {len(lo.trajectory)} poses -> {args.output_tum_path}")
    if args.output_simplemap:
        lo.save_simplemap(args.output_simplemap)
        print(f"Simplemap: {len(lo.simplemap)} keyframes -> {args.output_simplemap}")
    if args.output_local_map:
        lo.save_local_map(args.output_local_map)
        print(f"Local map -> {args.output_local_map}")
    if viewer is not None:
        viewer.render()  # final frame stays visible until shutdown
        viewer.stop()
    if args.viz_snapshot:
        from mola_lidar_odometry_tpu_torch.utils.viz import render_snapshot

        render_snapshot(lo, args.viz_snapshot)
        print(f"Snapshot -> {args.viz_snapshot}")
    return lo


if __name__ == "__main__":
    raise SystemExit(main())
