"""Port parity: se3, voxel keys/hashes, point packing and the main-path
filters of mola_lidar_odometry_tpu_torch against the JAX package.

Inputs come from seeded numpy and feed both packages.  Integer results
(hashes, packed keys and points, decimation indices) must match bit for
bit; float results to float32 tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mola_lidar_odometry_tpu.ops import filters as jf, se3 as jse3, voxel_hash as jvh
from mola_lidar_odometry_tpu.ops.pointcloud import PointCloud as JPC
from mola_lidar_odometry_tpu_torch.ops import filters as tf, se3 as tse3, voxel_hash as tvh
from mola_lidar_odometry_tpu_torch.ops.pointcloud import PointCloud as TPC

F32 = dict(rtol=1e-5, atol=1e-6)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def test_se3_matches_jax():
    rng = np.random.default_rng(0)
    xi = rng.normal(0, 0.8, (64, 6)).astype(np.float32)
    xi[:8, 3:] *= 1e-4  # series branch
    xi[8:12, 3:] = 0.0
    jp, tp = jse3.se3_exp(jnp.asarray(xi)), tse3.se3_exp(_t(xi))
    np.testing.assert_allclose(tp.R.numpy(), np.asarray(jp.R), **F32)
    np.testing.assert_allclose(tp.t.numpy(), np.asarray(jp.t), **F32)
    np.testing.assert_allclose(
        tse3.se3_log(tp).numpy(), np.asarray(jse3.se3_log(jp)), rtol=1e-4, atol=2e-5
    )
    np.testing.assert_allclose(
        tse3.so3_exp(_t(xi[:, 3:])).numpy(), np.asarray(jse3.so3_exp(jnp.asarray(xi[:, 3:]))), **F32
    )
    a, b = tse3.se3_exp(_t(xi[:32])), tse3.se3_exp(_t(xi[32:]))
    ja, jb = jse3.se3_exp(jnp.asarray(xi[:32])), jse3.se3_exp(jnp.asarray(xi[32:]))
    for got, ref in ((tse3.compose(a, b), jse3.compose(ja, jb)), (tse3.relative(a, b), jse3.relative(ja, jb))):
        np.testing.assert_allclose(got.R.numpy(), np.asarray(ref.R), **F32)
        np.testing.assert_allclose(got.t.numpy(), np.asarray(ref.t), **F32)
    pts = rng.normal(0, 20, (32, 50, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tse3.transform(a, _t(pts)).numpy(), np.asarray(jse3.transform(ja, jnp.asarray(pts))), rtol=1e-5, atol=2e-5
    )
    # the angle goes through arccos, whose slope near pi amplifies the f32
    # rounding of the trace (relative angles here reach ~3 rad)
    for got, ref in zip(tse3.pose_error_norms(a, b), jse3.pose_error_norms(ja, jb)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(tse3.rot_to_quat(a.R).numpy(), np.asarray(jse3.rot_to_quat(ja.R)), **F32)
    for got, ref in zip(tse3.rot_to_ypr(a.R), jse3.rot_to_ypr(ja.R)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_voxel_hash_and_keys_bit_exact():
    rng = np.random.default_rng(1)
    coords = np.concatenate(
        [
            rng.integers(-(1 << 30), 1 << 30, (4000, 3)),
            rng.integers(-3000, 3000, (4000, 3)),
            np.array([[0, 0, 0], [-1, -1, -1], [2047, 2048, 127], [2048, -2049, -129]]),
        ]
    ).astype(np.int32)
    for table in (1 << 10, 1 << 14, 1 << 19):
        np.testing.assert_array_equal(
            tf.voxel_hash(_t(coords), table).numpy(), np.asarray(jf.voxel_hash(jnp.asarray(coords), table))
        )
    np.testing.assert_array_equal(
        tvh.pack_key(_t(coords)).numpy(), np.asarray(jvh.pack_key(jnp.asarray(coords)))
    )
    anchor = np.array([3000, -2500, 60], np.int32)
    pk = tvh.pack_key(_t(coords))
    np.testing.assert_array_equal(
        tvh.unpack_key_near(pk, _t(anchor)).numpy(),
        np.asarray(jvh.unpack_key_near(jnp.asarray(pk.numpy()), jnp.asarray(anchor))),
    )
    xyz = rng.uniform(-3000, 3000, (8000, 3)).astype(np.float32)
    for vs in (1.0, 0.75, 0.3):
        c_t = tf.voxel_coords(_t(xyz), vs)
        c_j = jf.voxel_coords(jnp.asarray(xyz), jnp.float32(vs))
        np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))
        np.testing.assert_array_equal(
            tvh.pack_points(_t(xyz), c_t, torch.tensor(vs)).numpy(),
            np.asarray(jvh.pack_points(jnp.asarray(xyz), c_j, jnp.float32(vs))),
        )


def _cloud(rng, B, n, spread=40.0):
    xyz = rng.normal(0, spread, (B, n, 3)).astype(np.float32)
    xyz[:, : n // 8] = np.round(xyz[:, : n // 8])  # exact voxel-boundary points
    time = rng.uniform(-0.05, 0.05, (B, n)).astype(np.float32)
    valid = rng.random((B, n)) > 0.2
    valid[1, : n // 2] = False
    ring = rng.integers(0, 64, (B, n)).astype(np.int32)
    return xyz, time, valid, ring


@pytest.mark.parametrize("min_pts", [0, 900])
def test_decimate_first_point_bit_exact(min_pts):
    rng = np.random.default_rng(2)
    B, n = 2, 1500
    xyz, time, valid, ring = _cloud(rng, B, n)
    res = np.array([0.6, 1.3], np.float32)
    got = tf.decimate_voxels(
        TPC(_t(xyz), _t(time), torch.zeros(B, n), _t(ring), _t(valid)),
        _t(res), 700, min_input_points=min_pts,
    )
    for b in range(B):
        ref = jf.decimate_voxels(
            JPC(jnp.asarray(xyz[b]), jnp.asarray(time[b]), jnp.zeros(n), jnp.asarray(ring[b]), jnp.asarray(valid[b])),
            jnp.float32(res[b]), 700, min_input_points=min_pts,
        )
        np.testing.assert_array_equal(got.valid[b].numpy(), np.asarray(ref.valid))
        np.testing.assert_array_equal(got.xyz[b].numpy(), np.asarray(ref.xyz))
        np.testing.assert_array_equal(got.time[b].numpy(), np.asarray(ref.time))
        np.testing.assert_array_equal(got.ring[b].numpy(), np.asarray(ref.ring))


def test_range_bbox_timestamps_deskew_match_jax():
    rng = np.random.default_rng(3)
    B, n = 2, 900
    xyz, time, valid, ring = _cloud(rng, B, n, spread=15.0)
    tpc = TPC(_t(xyz), _t(time), torch.zeros(B, n), _t(ring), _t(valid))
    lo, hi = np.array([1.0, 3.0], np.float32), np.array([20.0, 30.0], np.float32)
    bmin = np.array([[-5, -5, 0.5], [-3, -4, -1]], np.float32)
    bmax = np.array([[5, 5, 4.0], [3, 4, 2]], np.float32)
    twist = np.array([[8.0, 0.1, 0.2, 0.01, -0.02, 0.3], [2.0, 0, 0, 0, 0, -0.5]], np.float32)
    btw, out = tf.filter_by_range(tpc, _t(lo), _t(hi))
    ins, outs = tf.filter_bounding_box(tpc, _t(bmin), _t(bmax))
    adj = tf.adjust_timestamps(tpc, offset=_t(np.array([0.0, 0.01], np.float32)))
    dsk = tf.deskew(adj, _t(twist))
    for b in range(B):
        jpc = JPC(jnp.asarray(xyz[b]), jnp.asarray(time[b]), jnp.zeros(n), jnp.asarray(ring[b]), jnp.asarray(valid[b]))
        jb, jo = jf.filter_by_range(jpc, jnp.float32(lo[b]), jnp.float32(hi[b]))
        np.testing.assert_array_equal(btw.valid[b].numpy(), np.asarray(jb.valid))
        np.testing.assert_array_equal(out.valid[b].numpy(), np.asarray(jo.valid))
        ji, jo2 = jf.filter_bounding_box(jpc, bmin[b], bmax[b])
        np.testing.assert_array_equal(ins.valid[b].numpy(), np.asarray(ji.valid))
        np.testing.assert_array_equal(outs.valid[b].numpy(), np.asarray(jo2.valid))
        ja = jf.adjust_timestamps(jpc, offset=jnp.float32([0.0, 0.01][b]))
        np.testing.assert_allclose(adj.time[b].numpy(), np.asarray(ja.time), rtol=0, atol=1e-8)
        jd = jf.deskew(ja, jnp.asarray(twist[b]))
        np.testing.assert_allclose(dsk.xyz[b].numpy(), np.asarray(jd.xyz), rtol=1e-6, atol=1e-5)
        np.testing.assert_allclose(
            tpc.bounding_radius()[b].numpy(), np.asarray(jpc.bounding_radius()), rtol=1e-6
        )
    comp = tpc.compact(600)
    for b in range(B):
        jc = JPC(jnp.asarray(xyz[b]), jnp.asarray(time[b]), jnp.zeros(n), jnp.asarray(ring[b]), jnp.asarray(valid[b])).compact(600)
        np.testing.assert_array_equal(comp.valid[b].numpy(), np.asarray(jc.valid))
        np.testing.assert_array_equal(comp.xyz[b].numpy(), np.asarray(jc.xyz))


def test_expr_matches_jax_on_tensors():
    from mola_lidar_odometry_tpu.utils.expr import Expr as JExpr
    from mola_lidar_odometry_tpu_torch.utils.expr import Expr as TExpr

    srcs = [
        "2.0*max(ADAPTIVE_THRESHOLD_SIGMA, 2.0*ADAPTIVE_THRESHOLD_SIGMA-(2.0*ADAPTIVE_THRESHOLD_SIGMA-0.5*ADAPTIVE_THRESHOLD_SIGMA)*ICP_ITERATION/30)",
        "(0.1e-2 + sqrt(wx^2+wy^2+wz^2)*0.1)*ESTIMATED_SENSOR_MAX_RANGE",
        "max(0.5, min(1.0, 0.015*ESTIMATED_SENSOR_MAX_RANGE))",
        "saturate(-wx*3 + 2^3 % 3, 0.1, 4)",
    ]
    env = {
        "ADAPTIVE_THRESHOLD_SIGMA": np.array([2.0, 0.7], np.float32),
        "ICP_ITERATION": np.array([0.0, 17.0], np.float32),
        "wx": np.array([0.1, -0.3], np.float32),
        "wy": np.array([0.0, 0.2], np.float32),
        "wz": np.array([0.5, 0.0], np.float32),
        "ESTIMATED_SENSOR_MAX_RANGE": np.array([80.0, 20.0], np.float32),
    }
    for s in srcs:
        got = TExpr(s)({k: _t(v) for k, v in env.items()})
        ref = JExpr(s)({k: jnp.asarray(v) for k, v in env.items()})
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
