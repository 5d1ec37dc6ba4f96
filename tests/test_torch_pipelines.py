"""Every shipped pipeline (the four top-level ones and the extras) built
and stepped by the port's ``LidarOdometry`` on the CPU at small sizes."""

import os

import numpy as np
import pytest
import torch


HERE = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture(autouse=True)
def one_thread():
    """The steps here are small: one torch thread each keeps the suite's
    parallel workers from oversubscribing the cores (as the family files)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

def _small_layers(cfg) -> dict:
    """1024 points for every layer a pipeline's filters and generators
    write (a layer without a size gets 65536)."""
    names = {"raw"}
    for block, entries in cfg.items():
        if block.startswith("observations_") and isinstance(entries, list):
            for e in entries:
                for k, v in ((e or {}).get("params") or {}).items():
                    if "layer" in k and not k.startswith("input") and isinstance(v, (str, list)):
                        names.update([v] if isinstance(v, str) else v)
    return {n: 1024 for n in names}


SHIPPED = ["lidar3d-default.yaml", "lidar3d-ndt.yaml", "lidar2d.yaml", "rgbd.yaml",
           "extras/lidar3d-dual-map.yaml", "extras/lidar3d-near-far.yaml", "extras/lidar3d-kissicp-like.yaml",
           "extras/lidar3d-intensity.yaml", "extras/lidar3d-edges.yaml"]


@pytest.mark.parametrize("rel", SHIPPED)
def test_every_shipped_pipeline_builds_and_steps(rel):
    """``LidarOdometry.from_yaml_file`` of the port builds each shipped
    pipeline at small sizes and steps two small scans (a planar ring for
    lidar2d); no pipeline names a queue A item any more."""
    from mola_lidar_odometry_tpu_torch.models.odometry import LidarOdometry as TLO
    from mola_lidar_odometry_tpu_torch.utils import sim

    from mola_lidar_odometry_tpu_torch.utils.config import load_yaml_file

    path = os.path.join(HERE, "..", "pipelines", rel)
    caps = dict(raw_capacity=1024, map_slots=1 << 12, layer_capacities=_small_layers(load_yaml_file(path, env={})))
    lo = TLO.from_yaml_file(path, env={}, device="cpu", **caps)
    ring = dict(n_rings=1, fov_up_deg=0.0, fov_down_deg=0.0) if rel == "lidar2d.yaml" else dict(n_rings=4)
    traj, scans = sim.simulate_sequence(2, n_azimuth=180, speed=1.0, **ring)
    outs = [lo.on_lidar_scan(x[v], traj.stamps[k], times=t[v], ring=r[v]) for k, (x, t, r, v) in enumerate(scans)]
    assert all(bool(o.processed) for o in outs) and int(outs[-1].n_raw) > 0
    assert all(np.isfinite(o.pose_t).all() for o in outs)
