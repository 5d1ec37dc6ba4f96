"""Port parity for the native host runtime binding (``utils/native.py``):
the cases of ``tests/test_native.py`` on the port's binding, which loads the
same ``native/libmola_tpu_native.so``; its decode equals the JAX package's
binding word for word and numpy's decode.  The library is built from
``native/`` into a temporary directory (the tests never write the repo's
copy, which other tests may be loading)."""

import math
import os
import shutil
import subprocess

import numpy as np
import pytest

NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "native")


def build_native(tmp_dir) -> str:
    """Build ``native/`` in ``tmp_dir`` with its Makefile; returns the
    library's path."""
    shutil.copytree(NATIVE_DIR, tmp_dir, ignore=shutil.ignore_patterns("*.so"), dirs_exist_ok=True)
    subprocess.run(["make", "-C", str(tmp_dir)], check=True, capture_output=True)
    return os.path.join(str(tmp_dir), "libmola_tpu_native.so")


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """(port binding, JAX binding), both on a library built from the repo's
    sources."""
    from mola_lidar_odometry_tpu.utils import native as jnative
    from mola_lidar_odometry_tpu_torch.utils import native

    path = build_native(tmp_path_factory.mktemp("native"))
    mp = pytest.MonkeyPatch()
    mp.setenv("MOLA_TPU_NATIVE_LIB", path)
    saved = [(m, m._LIB, m._TRIED) for m in (native, jnative)]
    for m in (native, jnative):
        m._LIB, m._TRIED = None, False
    assert native.available() and jnative.available()
    yield native, jnative
    for m, lib, tried in saved:
        m._LIB, m._TRIED = lib, tried
    mp.undo()


def test_decode_matches_numpy_and_jax(tmp_path, libs):
    native, jnative = libs
    raw = np.random.default_rng(0).uniform(-20, 20, (500, 4)).astype(np.float32)
    p = tmp_path / "scan.bin"
    raw.tofile(p)
    calls = native.decode_bin.calls
    xyz, inten, times, n = native.decode_bin(str(p), 1000, 0.0, 0.1)
    assert n == 500 and native.decode_bin.calls == calls + 1
    np.testing.assert_allclose(xyz[:n], raw[:, :3], rtol=1e-6)
    np.testing.assert_allclose(inten[:n], raw[:, 3], rtol=1e-6)
    az = np.arctan2(raw[:, 1], raw[:, 0])  # the azimuth timestamp model
    np.testing.assert_allclose(times[:n], az / (2 * np.pi) * 0.1, atol=1e-6)
    assert np.all(xyz[n:] == 0)
    for a, b in zip((xyz, inten, times, n), jnative.decode_bin(str(p), 1000, 0.0, 0.1)):
        np.testing.assert_array_equal(a, b)


def test_decode_vertical_correction(tmp_path, libs):
    native, _ = libs
    p = tmp_path / "one.bin"
    np.asarray([[10.0, 0.0, 0.0, 1.0]], np.float32).tofile(p)
    corr = math.radians(0.205)
    xyz, _, _, n = native.decode_bin(str(p), 10, corr, 0.0)
    assert abs(float(xyz[0, 2]) - 10.0 * math.sin(corr)) < 1e-5  # rotated up by corr
    assert abs(np.linalg.norm(xyz[0]) - 10.0) < 1e-5  # range preserved


def test_decode_capacity_trim(tmp_path, libs):
    native, _ = libs
    raw = np.random.default_rng(1).normal(size=(100, 4)).astype(np.float32)
    p = tmp_path / "big.bin"
    raw.tofile(p)
    xyz, _, _, n = native.decode_bin(str(p), 40, 0.0, 0.0)
    assert n == 40
    np.testing.assert_allclose(xyz[:40], raw[:40, :3], rtol=1e-6)


def test_prefetcher_in_order(tmp_path, libs):
    native, _ = libs
    paths = []
    for k in range(6):
        p = tmp_path / f"s{k}.bin"
        np.full((10, 4), float(k), np.float32).tofile(p)
        paths.append(str(p))
    pf = native.Prefetcher(paths, capacity=16, lookahead=2)
    for k in range(6):
        out = pf.next()
        assert out is not None
        xyz, _, _, n = out
        assert n == 10 and float(xyz[0, 0]) == float(k)
    assert pf.next() is None
    pf.close()


def test_write_f32(tmp_path, libs):
    native, _ = libs
    data = np.arange(12, dtype=np.float32).reshape(4, 3)
    p = tmp_path / "blob.bin"
    native.write_f32(str(p), data)
    np.testing.assert_array_equal(np.fromfile(p, np.float32).reshape(4, 3), data)


def test_decode_missing_file(libs):
    native, _ = libs
    with pytest.raises(IOError):
        native.decode_bin("/no/such/file.bin", 100)
