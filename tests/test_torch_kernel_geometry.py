"""Launch geometry of the redesigned kernel B3 (``align_geometry``): pure
Python, checked on the CPU.  The CUDA source takes these shapes as they are
(``csrc/align.cu``).  B1's and B2's geometry is in
``test_torch_kernel_geometry_capture.py``, the source patches of the probes
in ``test_torch_kernel_sources.py``."""

import pytest

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
