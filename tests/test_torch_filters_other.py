"""Port parity: the filters of the lidar3d-intensity, lidar3d-edges and rgbd
pipelines (``ops/filters.py``) against the JAX package's, on simulated
ring-ordered scans (seeded); their filter graphs are in
``test_torch_filter_graph.py``.

Each instance of a two-instance fleet is held against the jitted JAX
function on its own scan, padded to a capacity larger than its count: the
masks roll over the whole padded buffer in both packages, so the points
at both ends see the padding.  Masks and decimation winners are integers
and must match bit for bit; intensities are equal floats."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mola_lidar_odometry_tpu.ops import filters as jf
from mola_lidar_odometry_tpu.ops.pointcloud import PointCloud as JPC
from mola_lidar_odometry_tpu_torch.ops import filters as tf
from mola_lidar_odometry_tpu_torch.ops.pointcloud import PointCloud as TPC
from mola_lidar_odometry_tpu_torch.utils import sim

HERE = os.path.dirname(os.path.abspath(__file__))
CAP = 6144


@pytest.fixture(scope="module")
def clouds():
    """Two scans (two poses of one sequence) in padded buffers, with a
    seeded intensity."""
    traj, scans = sim.simulate_sequence(4, n_rings=12, n_azimuth=512, speed=2.0)
    rng = np.random.default_rng(11)
    B = 2
    arrs = dict(xyz=np.zeros((B, CAP, 3), np.float32), time=np.zeros((B, CAP), np.float32),
                intensity=np.zeros((B, CAP), np.float32), ring=np.zeros((B, CAP), np.int32),
                valid=np.zeros((B, CAP), bool))
    for b, k in enumerate((0, 3)):
        xyz, times, rings, valid = scans[k]
        n = int(valid.sum())
        assert n < CAP - 100
        arrs["xyz"][b, :n], arrs["time"][b, :n], arrs["ring"][b, :n] = xyz[valid], times[valid], rings[valid]
        arrs["intensity"][b, :n] = rng.gamma(2.0, 30.0, n)
        arrs["valid"][b, :n] = rng.random(n) > 0.02  # a few invalid points inside the rings too
    tpc = TPC(**{k: torch.from_numpy(v) for k, v in arrs.items()})
    jpcs = [JPC(**{k: jnp.asarray(v[b]) for k, v in arrs.items()}) for b in range(B)]
    return tpc, jpcs


def _each(jfn, tout, jpcs):
    for b, jpc in enumerate(jpcs):
        np.testing.assert_array_equal(np.asarray(tout[b]), np.asarray(jax.jit(jfn)(jpc)))


@pytest.mark.parametrize("kw", [dict(max_cosine=0.4, min_clearance=0.20, max_gap=1.0), {}],
                         ids=["edges-yaml", "defaults"])
def test_curvature_mask_matches_jax(clouds, kw):
    tpc, jpcs = clouds
    got = tf.curvature_mask(tpc, **kw)
    _each(lambda p: jf.curvature_mask(p, **kw), got, jpcs)
    assert int(got.sum()) > 50 and int((~got & tpc.valid).sum()) > 1000
    kept = tf.filter_curvature(tpc, **kw)
    np.testing.assert_array_equal(kept.valid.numpy(), (got & tpc.valid).numpy())


def test_curvature_mask_wraps_over_the_padding(clouds):
    """Points near the end of a full buffer compare with its head (JAX's
    ``jnp.roll`` over the instance's capacity), padding included."""
    tpc, jpcs = clouds
    n = int(tpc.valid[0].nonzero().max()) + 1
    sub = tpc._replace(**{f: getattr(tpc, f)[:, :n] for f in ("xyz", "time", "intensity", "ring", "valid")})
    jsub = [jp._replace(**{f: getattr(jp, f)[:n] for f in JPC._fields}) for jp in jpcs]
    got = tf.curvature_mask(sub, max_cosine=0.4, min_clearance=0.2, max_gap=1.0)
    _each(lambda p: jf.curvature_mask(p, max_cosine=0.4, min_clearance=0.2, max_gap=1.0), got, jsub)
    ring0 = sub.ring[0]
    assert int(ring0[0]) != int(ring0[n - 1]) and not got[0, :2].any() and not got[0, n - 2:].any()


@pytest.mark.parametrize("threshold,window", [(10.0, 6), (3.0, 4)])
def test_range_image_edge_mask_matches_jax(clouds, threshold, window):
    tpc, jpcs = clouds
    got = tf.range_image_edge_mask(tpc, score_threshold=threshold, row_window_length=window)
    _each(lambda p: jf.range_image_edge_mask(p, score_threshold=threshold, row_window_length=window), got, jpcs)
    assert int(got.sum()) > 20


def test_intensity_filters_match_jax(clouds):
    tpc, jpcs = clouds
    norm = tf.normalize_intensity(tpc)
    _each(lambda p: jf.normalize_intensity(p).intensity, norm.intensity, jpcs)
    assert float(norm.intensity.max()) == 1.0
    sel = tf.filter_by_intensity(norm, 0.1, torch.tensor([0.9, 0.6]))
    for b, (jp, hi) in enumerate(zip(jpcs, (0.9, 0.6))):
        want = jax.jit(lambda p: jf.filter_by_intensity(jf.normalize_intensity(p), 0.1, hi).valid)(jp)
        np.testing.assert_array_equal(sel.valid[b].numpy(), np.asarray(want))
    assert 0 < int(sel.valid.sum()) < int(tpc.valid.sum())


@pytest.mark.parametrize("vs,min_pts", [(0.5, 0), (1.3, 0), (0.5, 100000)])
def test_closest_to_average_decimation_matches_jax(clouds, vs, min_pts):
    tpc, jpcs = clouds
    got = tf.decimate_voxels(tpc, vs, 4096, method="ClosestToAverage", min_input_points=min_pts, table_size=1 << 14)
    for b, jp in enumerate(jpcs):
        want = jax.jit(lambda p: jf.decimate_voxels(p, vs, 4096, method="ClosestToAverage",
                                                    min_input_points=min_pts, table_size=1 << 14))(jp)
        for f in ("valid", "xyz", "time", "intensity", "ring"):
            np.testing.assert_array_equal(getattr(got, f)[b].numpy(), np.asarray(getattr(want, f)), err_msg=f)
    assert 100 < int(got.valid.sum()) <= int(tpc.valid.sum())


def test_closest_to_average_with_a_per_instance_resolution(clouds):
    tpc, jpcs = clouds
    got = tf.decimate_voxels(tpc, torch.tensor([0.5, 0.9]), 4096, method="ClosestToAverage", table_size=1 << 14)
    for b, (jp, vs) in enumerate(zip(jpcs, (0.5, 0.9))):
        want = jax.jit(lambda p: jf.decimate_voxels(p, vs, 4096, method="ClosestToAverage", table_size=1 << 14))(jp)
        np.testing.assert_array_equal(got.xyz[b].numpy(), np.asarray(want.xyz))
