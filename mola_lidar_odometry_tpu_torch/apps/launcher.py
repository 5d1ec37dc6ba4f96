"""mola-cli analogue: launch a module graph from a YAML file.

Counterpart of the reference's `mola-cli` + launch YAMLs (reference
mola-cli-launchs/*.yaml, e.g. lidar_odometry_from_kitti.yaml:7-48): a launch
file names a set of modules — an input dataset source, the LidarOdometry
front end (with its pipeline YAML), and optional visualization — and the
launcher instantiates them, wires observations from the source into the
odometry through the asynchronous runtime (utils/runtime.py), and spins
until the dataset ends or shutdown is requested.

Launch YAML schema (ours, structurally mirroring the reference's):

    modules:
      - name: dataset
        type: KittiOdometryDataset        # any reader in apps/datasets.py
        params: {sequence: '00'}
        real_time: false                  # replay at recorded rate if true
      - name: lidar_odometry
        type: LidarOdometry
        params:
          pipeline: pipelines/lidar3d-default.yaml
          raw_capacity: 131072
      - name: viz
        type: SnapshotViz                 # optional periodic PNG snapshots
        params: {every_n: 100, path: snapshots}

Port of ``mola_lidar_odometry_tpu/apps/launcher.py``: the same launch
files, read as they are; the odometry runs on ``--device`` (the card
unless ``cpu`` is given).

Usage: python -m mola_lidar_odometry_tpu_torch.apps.launcher <launch.yaml> [--device cpu]
"""

from __future__ import annotations

import sys
import time
from pathlib import Path
from typing import Any, Dict



def launch(launch_yaml: str, device="cuda"):
    """Run the launch file's module graph to its end; returns the
    ``LidarOdometry`` and the (shut down) ``AsyncLidarOdometry``."""
    from mola_lidar_odometry_tpu_torch.apps import datasets as D
    from mola_lidar_odometry_tpu_torch.models.odometry import LidarOdometry
    from mola_lidar_odometry_tpu_torch.utils.config import load_yaml_file
    from mola_lidar_odometry_tpu_torch.utils.runtime import AsyncLidarOdometry, Observation

    cfg = load_yaml_file(launch_yaml)
    modules = cfg.get("modules", []) or []

    dataset = None
    dataset_rt = False
    lo = None
    viz_cfg: Dict[str, Any] = {}
    outputs: Dict[str, Any] = {}

    for m in modules:
        typ = str(m.get("type", ""))
        p = m.get("params", {}) or {}
        if typ == "LidarOdometry":
            pipeline = p.pop("pipeline")
            overrides = {k: int(v) if isinstance(v, str) and v.isdigit() else v
                         for k, v in p.items() if k not in ("outputs",)}
            outputs = p.get("outputs", {}) or {}
            overrides.pop("outputs", None)
            lo = LidarOdometry.from_yaml_file(pipeline, device=device, **overrides)
        elif typ == "SnapshotViz":
            viz_cfg = p
        elif hasattr(D, typ):
            dataset_rt = bool(m.get("real_time", False))
            dataset = getattr(D, typ)(**p)
        else:
            raise ValueError(f"Unknown module type {typ!r} in {launch_yaml}")

    if dataset is None or lo is None:
        raise ValueError("launch file must define a dataset module and LidarOdometry")

    rt = AsyncLidarOdometry(lo)
    every_n = int(viz_cfg.get("every_n", 0) or 0)
    snap_dir = Path(viz_cfg.get("path", "snapshots"))
    if every_n:
        snap_dir.mkdir(parents=True, exist_ok=True)

    t_prev = None
    for i in range(len(dataset)):
        fr = dataset.get(i)
        if dataset_rt and t_prev is not None:
            time.sleep(max(0.0, fr.stamp - t_prev))
        t_prev = fr.stamp
        rt.on_new_observation(
            Observation(
                "lidar", fr.label, fr.stamp,
                {"xyz": fr.xyz, "times": fr.times,
                 "intensity": fr.intensity, "ring": fr.ring},
            )
        )
        # CLI-style backpressure (reference apps/...cli.cpp:519-521)
        while rt.is_busy():
            time.sleep(0.001)
        if rt.fatal_error:
            print("fatal error in odometry worker; stopping", file=sys.stderr)
            break
        if every_n and (i + 1) % every_n == 0:
            from mola_lidar_odometry_tpu_torch.utils.viz import render_snapshot

            render_snapshot(lo, snap_dir / f"snap_{i + 1:06d}.png")

    rt.shutdown()

    if outputs.get("tum"):
        lo.save_trajectory_tum(outputs["tum"])
    if outputs.get("simplemap"):
        lo.save_simplemap(outputs["simplemap"])
    if outputs.get("local_map"):
        lo.save_local_map(outputs["local_map"])
    print(
        f"done: {lo.frames_processed} frames processed, "
        f"{rt.dropped_observations} dropped, {len(lo.trajectory)} poses"
    )
    return lo, rt


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("launch_yaml")
    ap.add_argument("--device", default="cuda", help="where the odometry runs (cuda or cpu)")
    args = ap.parse_args(argv)
    launch(args.launch_yaml, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
