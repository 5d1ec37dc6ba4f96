"""Port parity: the plain twins of kernels B1 (capture) and B2 (reselect)
against the JAX package's Pallas kernels, run in interpret mode on the CPU
exactly as tests/test_pallas_match.py runs them.  Every output plane and the
gathered rows must match bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mola_lidar_odometry_tpu.ops import pallas_capture as jpc, voxel_hash as jvh
from mola_lidar_odometry_tpu.ops.pointcloud import PointCloud as JPC
from mola_lidar_odometry_tpu_torch.ops import pallas_capture as tpc, voxel_hash as tvh
from mola_lidar_odometry_tpu_torch.ops.pointcloud import PointCloud as TPC

B = 2


def _maps(pts, vs, slots=1 << 10, K=20):
    """The same points inserted into one JAX map per instance and one port
    fleet map; returns (jax maps, port map)."""
    jms = [jvh.insert(jvh.VoxelHashMap.create(slots, K, vs), JPC.from_xyz(jnp.asarray(p))) for p in pts]
    tm = tvh.VoxelHashMap.create(slots, K, vs, batch=B, device="cpu")
    tm, _ = tvh.insert_stats(tm, TPC.from_xyz(torch.from_numpy(np.stack(pts))))
    for b in range(B):
        np.testing.assert_array_equal(tm.data[b].numpy(), np.asarray(jms[b].data))
    return jms, tm


def _assert_planes(got, ref):
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("nbr", [4, 8, 27])
def test_capture_planar_plain_matches_pallas(nbr):
    rng = np.random.default_rng(2)
    pts = [rng.uniform(-6, 6, (800, 3)).astype(np.float32) for _ in range(B)]
    jms, tm = _maps(pts, 1.0)
    n = 100
    q = rng.uniform(-6, 6, (B, n, 3)).astype(np.float32)
    valid = rng.random((B, n)) > 0.2
    got = tpc.capture_planar(
        tm.data, tm.voxel_size, tm.epoch, torch.from_numpy(q), nbr, tile_q=128, K=20, stride=32,
        valid=torch.from_numpy(valid), return_rows=True,
    )
    for b in range(B):
        ref = jpc.capture_planar(
            jms[b].data, jms[b].voxel_size, jms[b].epoch, jnp.asarray(q[b]), nbr, interpret=True,
            tile_q=128, K=20, stride=32, valid=jnp.asarray(valid[b]), return_rows=True,
        )
        _assert_planes([x[b] for x in got], ref)
    assert float(got[3].sum()) > 0


def test_capture_reselect_plain_matches_pallas():
    rng = np.random.default_rng(7)
    pts = [rng.uniform(-6, 6, (600, 3)).astype(np.float32) for _ in range(B)]
    jms, tm = _maps(pts, 1.0)
    n = 100
    q0 = rng.uniform(-5, 5, (B, n, 3)).astype(np.float32)
    q1 = (q0 + rng.uniform(-0.06, 0.06, (B, n, 3))).astype(np.float32)
    valid = rng.random((B, n)) > 0.1
    *_, rows = tpc.capture_planar(
        tm.data, tm.voxel_size, tm.epoch, torch.from_numpy(q0), 8, tile_q=128,
        valid=torch.from_numpy(valid), return_rows=True,
    )
    got = tpc.capture_planar_reselect(
        rows, tm.voxel_size, tm.epoch, torch.from_numpy(q1), torch.from_numpy(q0), 8,
        valid=torch.from_numpy(valid),
    )
    for b in range(B):
        ref = jpc.capture_planar_reselect(
            jnp.asarray(rows[b].numpy()), jms[b].voxel_size, jms[b].epoch, jnp.asarray(q1[b]),
            jnp.asarray(q0[b]), 8, interpret=True, tile_q=128, valid=jnp.asarray(valid[b]),
        )
        _assert_planes([x[b] for x in got], ref)


def test_capture_division_vs_inverse_multiply_matches_jax():
    """vs = 0.75: B1 picks the bucket row from floor(q / vs) but derives the
    expected key from floor(q * (1/vs)).  Queries placed on the float32
    points where the two disagree must give the JAX package's result."""
    vs = np.float32(0.75)
    inv = np.float32(1.0) / vs
    k = np.arange(-24, 25)
    edge = np.nextafter((k * vs).astype(np.float32), np.float32(-np.inf))
    edge = edge[np.floor(edge / vs) != np.floor(edge * inv)]
    assert len(edge) >= 3  # the disagreement really occurs on this grid
    rng = np.random.default_rng(11)
    pts = [rng.uniform(-19, 19, (2500, 3)).astype(np.float32) for _ in range(B)]
    jms, tm = _maps(pts, vs, slots=1 << 12)
    q = rng.uniform(-4, 4, (B, 64, 3)).astype(np.float32)
    q[:, : len(edge), 0] = edge
    q[:, : len(edge), 1] = edge[::-1]
    got = tpc.capture_planar(tm.data, tm.voxel_size, tm.epoch, torch.from_numpy(q), 8, tile_q=128)
    for b in range(B):
        ref = jpc.capture_planar(
            jms[b].data, jms[b].voxel_size, jms[b].epoch, jnp.asarray(q[b]), 8, interpret=True,
            tile_q=128,
        )
        _assert_planes([x[b] for x in got], ref)
