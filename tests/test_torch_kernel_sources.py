"""The source patches of the GPU-only probes: B3's clock64 split
(``ops/align_clock_split.py``) and B2's probe copies
(``ops/reselect_probe.py``) patch scratch copies of the CUDA sources at
fixed places, checked on the CPU."""

import pytest


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
