"""The occupancy map's insert on the card against the CPU's (``ops/occupancy.py``):
two fleet instances, three scans each with the free-space walk, then a
prune.  Keys, slot ownership and the match table must be equal; the
log-odds too, with a tolerance of 0: within one pass every addend of a slot
is the same value, so the card's ``index_add_`` (atomics, in whatever order
they land) sums as the CPU's in-order adds do.  Marked ``cuda``; skips
without a CUDA device.  On a machine with a GPU:

    python -m pytest tests/test_torch_occupancy_cuda.py -q -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

from mola_lidar_odometry_tpu_torch.ops import occupancy as occ
from mola_lidar_odometry_tpu_torch.ops.pointcloud import PointCloud

LOGODDS_TOL = 0.0


@pytest.mark.cuda
def test_occupancy_insert_on_the_card_matches_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(5)
    B, n = 2, 4000
    maps = {dev: occ.OccupancyMap.create(1 << 15, 0.1, B, dev) for dev in ("cpu", "cuda")}
    for k in range(3):
        ang = rng.uniform(-np.pi, np.pi, (B, n))
        r = rng.uniform(0.3, 25.0, (B, n))  # the longest beams outrun the 128-step walk
        origin = np.array([[0.2 * k, -0.1 * k, 0.3]] * B, np.float32)
        xyz = np.stack([r * np.cos(ang), r * np.sin(ang), rng.normal(0, 0.05, (B, n))], -1).astype(np.float32)
        xyz += origin[:, None, :]
        valid = rng.random((B, n)) > 0.05
        for dev, m in maps.items():
            pc = PointCloud.from_xyz(torch.from_numpy(xyz).to(dev), valid=torch.from_numpy(valid).to(dev))
            maps[dev], _ = occ.insert_stats(m, pc, torch.from_numpy(origin).to(dev), max_ray_samples=128)
    for dev, m in maps.items():
        maps[dev] = occ.prune_farther_than(m, torch.zeros((B, 3), device=dev), 20.0)
    cpu, gpu = maps["cpu"], maps["cuda"]
    assert torch.equal(gpu.keys.cpu(), cpu.keys) and torch.equal(gpu.used.cpu(), cpu.used)
    assert float((gpu.logodds.cpu() - cpu.logodds).abs().max()) <= LOGODDS_TOL
    assert torch.equal(gpu.match.data.cpu(), cpu.match.data)
    assert int(cpu.num_voxels().min()) > 500 and int(cpu.used.sum()) > int(cpu.num_voxels().sum())
