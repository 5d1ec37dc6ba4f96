"""Launch geometry of the redesigned kernels B3 (``align_geometry``), B1
(``capture_geometry``) and B2 (``reselect_geometry``): pure Python, checked
on the CPU.  The CUDA sources take these shapes as they are
(``csrc/align.cu``, ``csrc/capture.cu``).  Also the sectors B2 reads
(``reselect_sectors``) and the source patches of B3's clock64 split
(``ops/align_clock_split.py``) and of B2's probe copies
(``ops/reselect_probe.py``)."""

import pytest
import torch

from mola_lidar_odometry_tpu_torch.ops.pallas_capture import capture_geometry, reselect_geometry, reselect_sectors
from mola_lidar_odometry_tpu_torch.ops.pallas_icp import MAX_NPAD, MAX_THREADS, SMEM_PLANES_MAX, align_geometry


@pytest.mark.parametrize(
    "npad,C,want",
    [
        (3072, 16, (16, 192, 192, 1, 49152, True)),  # the bench shape: planes in shared memory
        (3072, 2, (16, 192, 192, 1, 6144, True)),
        (3072, 54, (16, 192, 192, 1, 165888, True)),  # 27 probes
        (6656, 16, (16, 416, 416, 1, 106496, True)),
        (16128, 16, (16, 1008, 512, 2, 0, False)),  # 252 KB per CTA: read from global memory
        (9216, 54, (16, 576, 288, 2, 0, False)),
        (128, 2, (16, 8, 32, 1, 256, True)),
        (16384, 16, (16, 1024, 512, 2, 0, False)),  # the largest the fused path takes
    ],
)
def test_align_geometry(npad, C, want):
    g = align_geometry(npad, C)
    assert tuple(g) == want
    assert g.cluster * g.slice == npad and g.slice % 4 == 0  # 16-byte plane chunks per CTA
    assert g.threads % 32 == 0 and g.threads <= MAX_THREADS and g.threads * g.ppt >= g.slice
    assert g.smem_bytes <= SMEM_PLANES_MAX


@pytest.mark.parametrize("npad", [3000, MAX_NPAD + 128, 65536])
def test_align_geometry_rejects(npad):
    with pytest.raises(ValueError):
        align_geometry(npad, 16)


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


def test_align_clock_split_instruments_the_kernel_source():
    """The clock64 split of kernel B3 patches a scratch copy of
    ``csrc/align.cu`` at fixed places; each must still occur once."""
    from mola_lidar_odometry_tpu_torch.ops import align_clock_split, cuda_build

    src = (cuda_build._CSRC / "align.cu").read_text()
    out = align_clock_split.instrumented_source(src)
    assert out.count("clock64()") == 4 and out.count("lap(") == 4 and "align_read_clocks" in out
    with pytest.raises(RuntimeError, match="occurs 0 times"):
        align_clock_split.instrumented_source(src.replace("cur = s_pose;", "cur = s_pose ;"))


@pytest.mark.parametrize("name", ["two_scans", "sector64"])
def test_reselect_probe_patches_the_kernel_source(name):
    """Each probe copy of ``csrc/capture.cu`` patches fixed places; each must
    still occur once."""
    from mola_lidar_odometry_tpu_torch.ops import cuda_build, reselect_probe

    src = (cuda_build._CSRC / "capture.cu").read_text()
    out = reselect_probe.patched_source(src, name)
    assert all(out.count(new) == 1 for _, new in reselect_probe.PATCHES[name])
    old = reselect_probe.PATCHES[name][0][0]
    with pytest.raises(RuntimeError, match="occurs 0 times"):
        reselect_probe.patched_source(src.replace(old, old.replace("  ", " ", 1)), name)
