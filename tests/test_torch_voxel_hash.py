"""Port parity: the hash-voxel map of mola_lidar_odometry_tpu_torch against
the JAX package, word for word.

A 3-frame ``insert_stats`` sequence with the insert budget on (and an epoch
clear in between, so stale ways get reclaimed) must leave both tables
identical in every int32 word, with identical capacity counters; so must the
rolling-slab prune that follows, and the per-voxel capture on the result.
The scene straddles x = 2048 voxels, where ``pack_key`` sets bit 31 and the
insert's 2-key sort must order pkeys as SIGNED int32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mola_lidar_odometry_tpu.ops import voxel_hash as jvh
from mola_lidar_odometry_tpu.ops.pointcloud import PointCloud as JPC
from mola_lidar_odometry_tpu_torch.ops import voxel_hash as tvh
from mola_lidar_odometry_tpu_torch.ops.pointcloud import PointCloud as TPC

SLOTS, K, B = 1 << 10, 20, 2
VS = (1.0, 0.75)
_j_insert = jax.jit(jvh.insert_stats, static_argnames=("budget",))
_j_prune = jax.jit(jvh.prune_farther_than_slab)


def _frames(seed=0, n=3000, n_frames=3):
    rng = np.random.default_rng(seed)
    frames = []
    for f in range(n_frames):
        xyz = np.concatenate(
            [
                rng.uniform([2030, -20, -3], [2070, 20, 3], (n // 2, 3)),
                rng.uniform([-30, -30, -3], [30, 30, 3], (n - n // 2, 3)),
            ]
        ).astype(np.float32)
        xyz = np.stack([xyz, xyz[::-1] * np.float32(0.9)])  # (B, n, 3)
        valid = rng.random((B, n)) > 0.1
        frames.append((xyz, valid))
    return frames


def _jmaps():
    return [jvh.VoxelHashMap.create(SLOTS, K, vs) for vs in VS]


def _tmap():
    m = tvh.VoxelHashMap.create(SLOTS, K, 1.0, batch=B, device="cpu")
    return m._replace(voxel_size=torch.tensor(VS, dtype=torch.float32))


def _assert_same(tm, jms):
    for b, jm in enumerate(jms):
        np.testing.assert_array_equal(tm.data[b].numpy(), np.asarray(jm.data))
        assert int(tm.epoch[b]) == int(jm.epoch)
    assert tm.stride == jms[0].stride and tm.K == jms[0].K


@pytest.mark.parametrize("budget", [0, 700])
def test_insert_sequence_and_prune_word_for_word(budget):
    tm, jms = _tmap(), _jmaps()
    for f, (xyz, valid) in enumerate(_frames()):
        if f == 2:  # stale slots: the third frame reclaims dead ways
            tm = tm.clear()
            jms = [m.clear() for m in jms]
        tpc = TPC.from_xyz(torch.from_numpy(xyz), valid=torch.from_numpy(valid))
        tm, tst = tvh.insert_stats(tm, tpc, budget=budget)
        for b in range(B):
            jms[b], jst = _j_insert(
                jms[b], JPC.from_xyz(jnp.asarray(xyz[b]), valid=jnp.asarray(valid[b])), budget=budget
            )
            got = [int(x[b]) for x in tst]
            assert got == [int(jst.collision_drops), int(jst.full_drops), int(jst.deferred_drops)]
        _assert_same(tm, jms)
    assert int(tst.collision_drops.sum()) > 0  # buckets overflowed: the claim path ran
    if budget:
        assert int(tst.deferred_drops.sum()) > 0

    center = np.array([[2050.0, 0.0, 0.0], [-10.0, 5.0, 0.0]], np.float32)
    dist = np.array([12.0, 15.0], np.float32)
    for slab in range(64):  # a full sweep covers every row once
        tm = tvh.prune_farther_than_slab(
            tm, torch.from_numpy(center), torch.from_numpy(dist), torch.full((B,), slab, dtype=torch.int32)
        )
        jms = [
            _j_prune(jm, jnp.asarray(center[b]), jnp.float32(dist[b]), jnp.int32(slab))
            for b, jm in enumerate(jms)
        ]
    _assert_same(tm, jms)
    live_before = int((tm.count() > 0).sum())
    assert live_before > 0

    tm = tvh.zero_state_slab(tm, torch.tensor([3, 5], dtype=torch.int32))
    jms = [jvh.zero_state_slab(jm, jnp.int32(s)) for jm, s in zip(jms, (3, 5))]
    _assert_same(tm, jms)


@pytest.mark.parametrize("neighbors", [8, 27])
def test_capture_per_voxel_nn_matches_jax(neighbors):
    tm, jms = _tmap(), _jmaps()
    xyz, valid = _frames(n=2000, n_frames=1)[0]
    tm, _ = tvh.insert_stats(tm, TPC.from_xyz(torch.from_numpy(xyz), valid=torch.from_numpy(valid)))
    jms = [
        _j_insert(jm, JPC.from_xyz(jnp.asarray(xyz[b]), valid=jnp.asarray(valid[b])))[0]
        for b, jm in enumerate(jms)
    ]
    rng = np.random.default_rng(9)
    q = (xyz[:, :64] + rng.normal(0, 0.3, (B, 64, 3))).astype(np.float32)
    got = tvh.capture(tm, torch.from_numpy(q), neighbors, per_voxel_nn=True)
    for b, jm in enumerate(jms):
        ref = jvh.capture(jm, jnp.asarray(q[b]), neighbors, per_voxel_nn=True)
        np.testing.assert_array_equal(got.mask[b].numpy(), np.asarray(ref.mask))
        sel = got.mask[b].numpy()
        np.testing.assert_allclose(got.pts[b].numpy()[sel], np.asarray(ref.pts)[sel], rtol=0, atol=1e-6)
