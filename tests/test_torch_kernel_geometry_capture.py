"""Launch geometry of the redesigned kernels B1 (``capture_geometry``) and
B2 (``reselect_geometry``), and the sectors B2 reads (``reselect_sectors``):
pure Python, checked on the CPU.  The CUDA source takes these shapes as they
are (``csrc/capture.cu``)."""

import pytest
import torch

from mola_lidar_odometry_tpu_torch.ops.pallas_capture import capture_geometry, reselect_geometry, reselect_sectors


@pytest.mark.parametrize(
    "B,P,npad,grid", [(8, 8, 3072, (48, 8, 8)), (3, 27, 768, (12, 27, 3)), (1, 1, 128, (2, 1, 1))]
)
def test_capture_geometry(B, P, npad, grid):
    g = capture_geometry(B, P, npad)
    assert g.grid == grid and g.threads == 64
    assert g.smem_bytes == 2 * 32 * 528  # two warps' 32 rows, 16 bytes of padding each


def test_capture_geometry_rejects_oversized_grid():
    with pytest.raises(ValueError):
        capture_geometry(70000, 8, 3072)


@pytest.mark.parametrize(
    "B,P,npad,grid", [(8, 8, 3072, (24, 8, 8)), (3, 27, 768, (6, 27, 3)), (1, 1, 128, (1, 1, 1))]
)
def test_reselect_geometry(B, P, npad, grid):
    g = reselect_geometry(B, P, npad)
    assert g.grid == grid and g.threads == 128  # one query per thread, i fastest


@pytest.mark.parametrize("B,P,npad", [(70000, 8, 3072), (8, 70000, 128), (8, 27, 1 << 24)])
def test_reselect_geometry_rejects_oversized_grid(B, P, npad):
    with pytest.raises(ValueError):
        reselect_geometry(B, P, npad)


def test_reselect_sectors_count_what_the_selection_needs():
    """Every probe reads its 4 way-header sectors; a live probe also the
    sectors of its way that hold a word k < min(cnt, K) past the first six."""
    rows = torch.zeros((1, 1, 128, 128), dtype=torch.int32)  # every pkey 0: the key of voxel (0, 0, 0)
    q = torch.full((1, 128, 3), 0.5)
    epoch = torch.tensor([3], dtype=torch.int32)
    rows[0, 0, 0, 32 + 1] = (3 << 16) | 20  # way 1 live, 20 words: 2 sectors more
    rows[0, 0, 1, 96 + 1] = (3 << 16) | 7  # way 3, word 6 in the second sector: 1 more
    rows[0, 0, 2, 1] = (2 << 16) | 20  # a stale epoch: dead, headers only
    rows[0, 0, 3, 64 + 1] = (3 << 16) | 6  # words 0-5 all in the header sector
    rows[0, 0, 4, 1] = (3 << 16) | 40  # cnt above K: K words
    assert reselect_sectors(rows, torch.ones(1), epoch, q, 1, K=20, stride=32) == (128 * 4 + 2 + 1 + 2, 20 + 7 + 6 + 20)
    rows = torch.zeros_like(rows)  # 2 ways of 64 words, K = 32
    rows[0, 0, 0, 64 + 1] = (3 << 16) | 20  # way 1 live, 20 words: 2 sectors more
    rows[0, 0, 4, 1] = (3 << 16) | 40  # 32 words: 4 sectors more
    assert reselect_sectors(rows, torch.ones(1), epoch, q, 1, K=32, stride=64) == (128 * 2 + 2 + 4, 20 + 32)
