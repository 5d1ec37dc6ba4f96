"""The port's filters on the card: ``decimate_voxels(method="ClosestToAverage")``
gives the same points on every run (its centroid sums do not depend on the
order in which the card's threads land) and the CPU's points, but for
voxels whose centroid rounds apart.  Marked ``cuda``; skips without a CUDA
device.  On a machine with a GPU:

    python -m pytest tests/test_torch_filters_cuda.py -q -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

from mola_lidar_odometry_tpu_torch.ops import filters as F
from mola_lidar_odometry_tpu_torch.ops.pointcloud import PointCloud


@pytest.mark.cuda
def test_closest_to_average_is_deterministic_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(3)
    # 2 instances of 60000 points in a 6 m cube: ~200 points per 1 m voxel,
    # so every voxel's sum runs through the warp-wide reduction
    xyz = torch.from_numpy(rng.uniform(-3, 3, (2, 60000, 3)).astype(np.float32))
    valid = torch.from_numpy(rng.random((2, 60000)) > 0.05)
    pc = PointCloud.from_xyz(xyz)._replace(valid=valid)
    cpu = F.decimate_voxels(pc, 1.0, 4096, method="ClosestToAverage", table_size=1 << 14)
    gpu = pc._replace(**{k: getattr(pc, k).cuda() for k in pc._fields})
    runs = [F.decimate_voxels(gpu, 1.0, 4096, method="ClosestToAverage", table_size=1 << 14) for _ in range(5)]
    for r in runs[1:]:
        for a, b in zip(runs[0], r):
            assert torch.equal(a, b)
    got = runs[0]._replace(**{k: getattr(runs[0], k).cpu() for k in pc._fields})
    assert torch.equal(got.count(), cpu.count())  # one point per voxel on both
    for b in range(2):
        rows = [{tuple(p) for p in c.xyz[b][c.valid[b]].tolist()} for c in (got, cpu)]
        # a centroid an ulp apart may pick another point of its voxel
        assert len(rows[0] & rows[1]) >= 0.95 * len(rows[1])
