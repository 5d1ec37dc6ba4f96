"""Port parity for kernel B4's module: ``pallas_match.nn_select_plain`` and
``to_planar`` of mola_lidar_odometry_tpu_torch against the JAX package's
``pallas_match.nn_select`` (the Pallas kernel in interpret mode on the CPU)
and against ``voxel_hash.nn_from``, on seeded numpy inputs.

Tolerances.  XLA's CPU code may contract ``dx*dx + dy*dy + dz*dz`` into
fused multiply-adds, which the port's eager ops never do, so against JAX
``d2min`` agrees to rtol 1e-6 and the chosen target is required to be equal
wherever the two best distances differ by more than 1e-6 relative.  The
synthetic case (exact ties, a masked candidate 0, queries with no candidate
at all) uses small integer coordinates, where every product and sum is exact
in float32 under either rounding, so it must agree exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mola_lidar_odometry_tpu.ops import pallas_match as jpm, voxel_hash as jvh
from mola_lidar_odometry_tpu_torch.ops import maps as tmaps, pallas_match as tpm, voxel_hash as tvh
from mola_lidar_odometry_tpu_torch.ops.pointcloud import PointCloud as TPC

B, N = 2, 200  # N is not a multiple of the TPU kernel's 128-query tile


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(0)
    pts = rng.uniform(-8, 8, (4000, 3)).astype(np.float32)
    pts[:2000, 2] = 0.0
    tm = tvh.VoxelHashMap.create(1 << 12, 10, 1.0, batch=B, device="cpu")
    tm, _ = tvh.insert_stats(tm, TPC.from_xyz(torch.from_numpy(np.stack([pts] * B))))
    # The JAX map takes the port's table (the layout is shared word for word;
    # tests/test_torch_voxel_hash.py holds the two inserts against each other).
    jm = jvh.VoxelHashMap.create(1 << 12, 10, 1.0)._replace(data=jnp.asarray(tm.data[0].numpy()))
    assert (jm.K, jm.stride, int(jm.epoch)) == (tm.K, tm.stride, int(tm.epoch[0]))
    base = pts[rng.integers(0, 4000, N)]
    # instance 1's queries sit 0.4 m off the surfaces and partly outside the
    # mapped volume, so some have no candidate
    q = np.stack([base + rng.normal(0, 0.03, (N, 3)), base * 1.3 + 0.4]).astype(np.float32)
    valid = rng.random((B, N)) > 0.1
    return jm, tm, q, valid


def _second_best_gap(planar, q):
    """Relative gap between the best and second-best masked distances."""
    d2 = (planar.x - q[..., 0:1]) ** 2 + (planar.y - q[..., 1:2]) ** 2 + (planar.z - q[..., 2:3]) ** 2
    d2 = torch.where(planar.mask > 0, d2, torch.inf)
    two = torch.topk(d2, 2, dim=-1, largest=False).values
    return ((two[..., 1] - two[..., 0]) / torch.clamp(two[..., 0], min=1e-12)).numpy()


@pytest.mark.parametrize("nbr", [8, 27])  # C = 16 and C = 54
def test_nn_select_plain_matches_pallas_and_nn_from(scene, nbr):
    jm, tm, q, valid = scene
    tq, tvalid = torch.from_numpy(q), torch.from_numpy(valid)
    tcs = tvh.capture(tm, tq, nbr, per_voxel_nn=True)
    tplanar = tpm.to_planar(tcs)
    C = 2 * nbr
    assert tplanar.x.shape == (B, N, C) and all(p.is_contiguous() for p in tplanar)
    ttgt, td2 = tpm.nn_select(tplanar, tq)  # CPU tensors: the plain twin
    ftgt, fd2, ffound = tvh.nn_from(tcs, tq, tvalid)
    mtgt, md2, mfound = tmaps.match_p2p(tplanar, tq, tvalid)
    gap = _second_best_gap(tplanar, tq)
    n_none = 0
    for b in range(B):
        jcs = jvh.capture(jm, jnp.asarray(q[b]), nbr, True)
        jplanar = jpm.to_planar(jcs)
        # to_planar: equal up to the JAX package's lane padding of C to 128
        for tp, jp in zip(tplanar, jplanar):
            np.testing.assert_array_equal(tp[b].numpy(), np.asarray(jp)[:, :C])
            assert not np.asarray(jp)[:, C:].any()
        jtgt, jd2 = jpm.nn_select(jplanar, jnp.asarray(q[b]), interpret=True)
        jtgt, jd2 = np.asarray(jtgt), np.asarray(jd2)
        np.testing.assert_allclose(td2[b].numpy(), jd2, rtol=1e-6)
        none = jd2 > 1e37
        np.testing.assert_array_equal(td2[b].numpy()[none], jd2[none])  # 3.4e38 exactly, not inf
        clear = none | (gap[b] > 1e-6)
        np.testing.assert_array_equal(ttgt[b].numpy()[clear], jtgt[clear])
        assert clear.mean() > 0.99
        n_none += int(none.sum())
        # against the XLA twin of the kernel, through maps.match_p2p
        xtgt, xd2, xfound = jvh.nn_from(jcs, jnp.asarray(q[b]), jnp.asarray(valid[b]))
        np.testing.assert_array_equal(mfound[b].numpy(), np.asarray(xfound))
        np.testing.assert_allclose(md2[b].numpy(), np.asarray(xd2), rtol=1e-6)
    assert n_none > 0, "the scene must hold queries with no candidate"
    # the port's own two routes agree: planar select and nn_from
    np.testing.assert_array_equal(mfound.numpy(), ffound.numpy())
    np.testing.assert_allclose(md2.numpy(), fd2.numpy(), rtol=1e-6)
    both = ffound.numpy() & (gap > 1e-6)
    np.testing.assert_array_equal(mtgt.numpy()[both], ftgt.numpy()[both])
    assert torch.isinf(md2[~mfound]).all()


def test_nn_select_plain_ties_masks_and_empty_rows_exact():
    """Exact ties go to the lowest candidate index, a masked candidate 0 is
    skipped, and a query with no live candidate returns 3.4e38 and the
    coordinates of candidate 0 — exactly as the Pallas kernel."""
    rng = np.random.default_rng(3)
    C = 54
    cand = rng.integers(-6, 7, (N, C, 3)).astype(np.float32)
    cand[cand == 0] = -0.0  # the one-hot sum turns a winning -0.0 into +0.0
    mask = rng.random((N, C)) > 0.3
    q = rng.integers(-3, 4, (N, 3)).astype(np.float32)
    cand[:50, 7] = cand[:50, 3]  # exact duplicates: ties
    cand[:50, 20] = cand[:50, 3]
    mask[:50, [3, 7, 20]] = True
    cand[50:80, 0] = q[50:80]  # candidate 0 would win at distance 0, but is masked
    mask[50:80, 0] = False
    mask[80:100] = False  # no candidate at all
    mask[100:110] = False
    mask[100:110, C - 1] = True  # only the last candidate is live
    jplanar = jpm.to_planar(jvh.CandSet(jnp.asarray(cand), jnp.asarray(mask)))
    jtgt, jd2 = jpm.nn_select(jplanar, jnp.asarray(q), interpret=True)
    tplanar = tpm.to_planar(tvh.CandSet(torch.from_numpy(cand[None]), torch.from_numpy(mask[None])))
    ttgt, td2 = tpm.nn_select_plain(tplanar, torch.from_numpy(q[None]))
    np.testing.assert_array_equal(td2[0].numpy(), np.asarray(jd2))
    np.testing.assert_array_equal(ttgt[0].numpy(), np.asarray(jtgt))
    z = ttgt.numpy()
    assert (z == 0).any() and not np.signbit(z[z == 0]).any()
    assert (td2[0, 80:100] == np.float32(3.4e38)).all()
    np.testing.assert_array_equal(ttgt[0, 80:100].numpy(), cand[80:100, 0] + 0.0)
    np.testing.assert_array_equal(ttgt[0, 100:110].numpy(), cand[100:110, C - 1] + 0.0)
    # ties: the winner is never a later duplicate when the earlier one ties
    d2 = ((cand - q[:, None]) ** 2).sum(-1)
    d2 = np.where(mask, d2, np.float32(3.4e38))
    np.testing.assert_array_equal(ttgt[0].numpy(), cand[np.arange(N), d2.argmin(-1)] + 0.0)


def test_nn2_from_matches_jax(scene):
    """The two-nearest select of ``pairingsPerPoint: 2`` on full per-voxel
    candidate sets (C = P*K)."""
    jm, tm, q, valid = scene
    tq, tvalid = torch.from_numpy(q), torch.from_numpy(valid)
    tcs = tvh.capture(tm, tq, 8, per_voxel_nn=False)
    tpt, td2, tfound = tvh.nn2_from(tcs, tq, tvalid)
    for b in range(B):
        jcs = jvh.capture(jm, jnp.asarray(q[b]), 8, False)
        np.testing.assert_array_equal(tcs.mask[b].numpy(), np.asarray(jcs.mask))
        jpt, jd2, jfound = jvh.nn2_from(jcs, jnp.asarray(q[b]), jnp.asarray(valid[b]))
        np.testing.assert_array_equal(tfound[b].numpy(), np.asarray(jfound))
        np.testing.assert_allclose(td2[b].numpy(), np.asarray(jd2), rtol=1e-6)
        with np.errstate(invalid="ignore"):
            srt = np.sort(np.where(np.asarray(jcs.mask), ((np.asarray(jcs.pts) - q[b][:, None]) ** 2).sum(-1), np.inf), -1)
            clear = np.asarray(jfound).all(-1) & ((srt[:, 1] - srt[:, 0]) > 1e-6 * srt[:, 0]) & (
                (srt[:, 2] - srt[:, 1]) > 1e-6 * srt[:, 1])
        np.testing.assert_array_equal(tpt[b].numpy()[clear], np.asarray(jpt)[clear])
        assert clear.sum() > N // 4
