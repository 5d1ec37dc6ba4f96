"""Port parity: the NDT map of mola_lidar_odometry_tpu_torch (``ops/ndt.py``)
against the JAX package's ``ops/ndt.py``, table word for word.

Mirrors the NDT cases of ``tests/test_maps.py`` on a fleet of two
instances, each held against the JAX function on its own data (seeded
planes and clutter, two voxel sizes):

  * a 3-frame insert, with and without the ``min_distance`` sub-cell dedup:
    keys, state words (epoch and counts) and dedup bits bit for bit, equal
    capacity counters; moment and mean lanes within 2e-5 and the normals
    of plane voxels within 1e-4 (the port sums a voxel's moments in
    float64, JAX in a float32 ``associative_scan``); a plane flag may
    differ only where the voxel's eigenvalue ratio sits on the gate, and
    each such flip is reported;
  * prune, then re-insert into the reclaimed slot;
  * capture, ``p2p_from`` and ``p2pl_from`` on the result, and the
    ``maps`` dispatch (create, insert, prune, queries, point view);
  * the closed-form eigen solve, the plane fit over point-map candidates
    (``voxel_hash.p2pl_from``) and an NDT local map saved by one package
    and loaded by the other."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mola_lidar_odometry_tpu.ops import ndt as jndt
from mola_lidar_odometry_tpu.ops.pointcloud import PointCloud as JPC
from mola_lidar_odometry_tpu_torch.ops import linalg as tlinalg, maps as tmaps, ndt as tndt
from mola_lidar_odometry_tpu_torch.ops.pointcloud import PointCloud as TPC

SLOTS, B = 1 << 11, 2
VS = (1.0, 0.75)
RATIO = 0.05
INT_LANES = [0, 1] + list(range(18, 32))
F32_TOL = 2e-5  # moment sums (O(voxel size)) and means
NRM_TOL = 1e-4  # unit plane normals
_j_insert = jax.jit(jndt.insert_stats, static_argnames=("min_distance",))
_j_prune = jax.jit(jndt.prune_farther_than)


def _scene(rng, n, shift):
    """Ground, two walls and clutter in a 24 m box, moved by ``shift``."""
    k = n // 4
    ground = np.c_[rng.uniform(-12, 12, (k, 2)), rng.normal(-1.5, 0.02, k)]
    wall_x = np.c_[rng.normal(8.0, 0.02, k), rng.uniform(-12, 12, k), rng.uniform(-1.5, 3, k)]
    wall_y = np.c_[rng.uniform(-12, 12, k), rng.normal(-6.0, 0.02, k), rng.uniform(-1.5, 3, k)]
    clutter = rng.uniform([-12, -12, -1.5], [12, 12, 3], (n - 3 * k, 3))
    return (np.concatenate([ground, wall_x, wall_y, clutter]) + shift).astype(np.float32)


def _frames(seed=0, n=3000, n_frames=3):
    rng = np.random.default_rng(seed)
    frames = []
    for f in range(n_frames):
        xyz = np.stack([_scene(rng, n, [0.3 * f, 0, 0]), _scene(rng, n, [500.0 - 0.2 * f, -300.0, 4.0])])
        frames.append((xyz, rng.random((B, n)) > 0.1))
    return frames


def _jmaps():
    return [jndt.NdtMap.create(SLOTS, vs, RATIO) for vs in VS]


def _tmap():
    m = tndt.NdtMap.create(SLOTS, 1.0, RATIO, batch=B, device="cpu")
    return m._replace(voxel_size=torch.tensor(VS, dtype=torch.float32))


def _jpc(xyz, valid, b):
    return JPC.from_xyz(jnp.asarray(xyz[b]), valid=jnp.asarray(valid[b]))


def _tpc(xyz, valid):
    return TPC.from_xyz(torch.from_numpy(xyz), valid=torch.from_numpy(valid))


def _eigen_ratio(ss, s, n):
    """lambda_min / lambda_mid of the voxels' covariances (float64)."""
    n = np.maximum(n, 1)[:, None]
    mean = s / n
    c = ss / n
    cov = np.stack([
        np.stack([c[:, 0], c[:, 3], c[:, 4]], -1),
        np.stack([c[:, 3], c[:, 1], c[:, 5]], -1),
        np.stack([c[:, 4], c[:, 5], c[:, 2]], -1),
    ], -2) - mean[:, :, None] * mean[:, None, :]
    ev = np.linalg.eigvalsh(cov)
    return ev[:, 0] / np.maximum(ev[:, 1], 1e-12)


def _assert_tables(tm, jms, flips):
    """Integer lanes equal, float lanes within ``F32_TOL``; plane-flag
    flips only on the eigenvalue gate (appended to ``flips``)."""
    for b, jm in enumerate(jms):
        tw = tm.data[b].numpy().reshape(-1, 32)
        jw = np.asarray(jm.data).reshape(-1, 32)
        np.testing.assert_array_equal(tw[:, INT_LANES], jw[:, INT_LANES])
        assert int(tm.epoch[b]) == int(jm.epoch)
        live = np.asarray(jm.n) > 0
        tf, jf = tw[:, 2:17].view(np.float32), jw[:, 2:17].view(np.float32)
        np.testing.assert_allclose(tf[live, :12], jf[live, :12], rtol=0, atol=F32_TOL)  # moments, mean
        # a normal is defined where the voxel is a plane (a voxel of 2-4
        # points has a degenerate covariance and an arbitrary normal)
        planes = live & (tw[:, 17] > 0) & (jw[:, 17] > 0)
        np.testing.assert_allclose(tf[planes, 12:], jf[planes, 12:], rtol=0, atol=NRM_TOL)
        flip = np.flatnonzero(live & (tw[:, 17] != jw[:, 17]))
        if flip.size:
            ratio = _eigen_ratio(np.asarray(jm.ss)[flip], np.asarray(jm.s)[flip], np.asarray(jm.n)[flip])
            np.testing.assert_allclose(ratio, RATIO, rtol=1e-3, err_msg="a plane flag flipped off the gate")
            flips += [(b, int(i), float(r)) for i, r in zip(flip, ratio)]


@pytest.mark.parametrize("min_distance", [0.0, 0.2], ids=["plain", "dedup"])
def test_insert_three_frames_matches_jax(min_distance):
    jms, tm = _jmaps(), _tmap()
    flips = []
    for xyz, valid in _frames():
        tm, ts = tndt.insert_stats(tm, _tpc(xyz, valid), min_distance)
        for b in range(B):
            jms[b], js = _j_insert(jms[b], _jpc(xyz, valid, b), min_distance=min_distance)
            assert int(ts.collision_drops[b]) == int(js.collision_drops)
            assert int(ts.full_drops[b]) == int(js.full_drops) == 0
        _assert_tables(tm, jms, flips)
    for b, jm in enumerate(jms):
        assert int(np.sum(np.asarray(jm.n) > 0)) > 500 and int(np.sum(np.asarray(jm.plane_ok))) > 100
        np.testing.assert_array_equal(tm.n()[b].numpy(), np.asarray(jm.n))
        differ = np.flatnonzero(tm.plane_ok()[b].numpy() != np.asarray(jm.plane_ok))
        assert set(differ.tolist()) <= {i for c, i, _ in flips if c == b}
    print(f"plane-flag flips (instance, slot, eigen ratio): {flips}")


def test_dedup_rejects_stored_subcells_across_frames():
    """The same points inserted twice with ``min_distance``: the second
    batch is rejected whole, the voxels stay live with unchanged moments."""
    xyz, valid = _frames(seed=3, n_frames=1)[0]
    jms, tm = _jmaps(), _tmap()
    for _ in range(2):
        tm, _ = tndt.insert_stats(tm, _tpc(xyz, valid), 0.5)
        for b in range(B):
            jms[b], _ = _j_insert(jms[b], _jpc(xyz, valid, b), min_distance=0.5)
    _assert_tables(tm, jms, [])
    once, _ = tndt.insert_stats(_tmap(), _tpc(xyz, valid), 0.5)
    np.testing.assert_array_equal(tm.data.numpy(), once.data.numpy())


def test_prune_then_reinsert_into_a_reclaimed_slot():
    frames = _frames(seed=1)
    jms, tm = _jmaps(), _tmap()
    xyz, valid = frames[0]
    tm, _ = tndt.insert_stats(tm, _tpc(xyz, valid))
    for b in range(B):
        jms[b], _ = _j_insert(jms[b], _jpc(xyz, valid, b))
    centers = np.float32([[5.0, 0.0, 0.0], [495.0, -300.0, 4.0]])
    tm = tndt.prune_farther_than(tm, torch.from_numpy(centers), torch.tensor([6.0, 4.0]))
    for b, d in enumerate((6.0, 4.0)):
        jms[b] = _j_prune(jms[b], jnp.asarray(centers[b]), d)
    _assert_tables(tm, jms, [])
    before = [int((np.asarray(jm.n) > 0).sum()) for jm in jms]
    xyz, valid = frames[2]
    tm, _ = tndt.insert_stats(tm, _tpc(xyz, valid))
    for b in range(B):
        jms[b], _ = _j_insert(jms[b], _jpc(xyz, valid, b))
    _assert_tables(tm, jms, [])
    assert all(int((np.asarray(jm.n) > 0).sum()) > n for jm, n in zip(jms, before))


@pytest.fixture(scope="module")
def filled():
    jms, tm = _jmaps(), _tmap()
    for xyz, valid in _frames(seed=2):
        tm, _ = tndt.insert_stats(tm, _tpc(xyz, valid), 0.2)
        for b in range(B):
            jms[b], _ = _j_insert(jms[b], _jpc(xyz, valid, b), min_distance=0.2)
    _assert_tables(tm, jms, [])
    # the tables are equal in every integer word; start the queries from
    # one table so their outputs compare exactly
    jms = [jm._replace(data=jnp.asarray(tm.data[b].numpy())) for b, jm in enumerate(jms)]
    rng = np.random.default_rng(7)
    q = np.stack([_scene(rng, 1200, [0.1, 0.05, 0.0]), _scene(rng, 1200, [500.1, -299.9, 4.0])])
    qv = rng.random((B, 1200)) > 0.05
    return jms, tm, q, qv


@pytest.mark.parametrize("neighbors", [27, 8])
def test_capture_and_matches_equal_jax(filled, neighbors):
    jms, tm, q, qv = filled
    tcs = tndt.capture(tm, torch.from_numpy(q), neighbors)
    tp2p = tndt.p2p_from(tcs, torch.from_numpy(q), torch.from_numpy(qv))
    tp2pl = tndt.p2pl_from(tcs, torch.from_numpy(q), torch.from_numpy(qv))
    for b, jm in enumerate(jms):
        jcs = jax.jit(jndt.capture, static_argnums=2)(jm, jnp.asarray(q[b]), neighbors)
        live = np.asarray(jcs.live)
        np.testing.assert_array_equal(tcs.live[b].numpy(), live)
        np.testing.assert_array_equal(tcs.plane_ok[b].numpy(), np.asarray(jcs.plane_ok))
        np.testing.assert_array_equal(tcs.mu[b].numpy()[live], np.asarray(jcs.mu)[live])
        np.testing.assert_array_equal(tcs.nrm[b].numpy()[live], np.asarray(jcs.nrm)[live])
        jp2p = jax.jit(jndt.p2p_from)(jcs, jnp.asarray(q[b]), jnp.asarray(qv[b]))
        jp2pl = jax.jit(jndt.p2pl_from)(jcs, jnp.asarray(q[b]), jnp.asarray(qv[b]))
        # (tgt, d2, found) and (plane_pt, normal, d2, found); the points of
        # queries with no pairing are padding
        for tout, jout in ((tp2p, jp2p), (tp2pl, jp2pl)):
            found = np.asarray(jout[-1])
            np.testing.assert_array_equal(tout[-1][b].numpy(), found)
            np.testing.assert_array_equal(tout[-2][b].numpy(), np.asarray(jout[-2]))
            for got, want in zip(tout[:-2], jout[:-2]):
                np.testing.assert_array_equal(got[b].numpy()[found], np.asarray(want)[found])
        assert int(np.asarray(jp2pl[3]).sum()) > 200 and int(np.asarray(jp2p[2]).sum()) > 500


def test_maps_dispatch_on_an_ndt_layer(filled):
    """``ops/maps.py`` on an NDT layer: create from its YAML block, insert
    through the layer definition (its ``min_distance``), amortized prune
    (the full prune), point view, queries."""
    from mola_lidar_odometry_tpu.ops import maps as jmaps

    block = {"class": "mola::NDT", "creationOpts": {"voxel_size": 1.0},
             "insertOpts": {"min_distance_between_points": 0.2, "max_eigen_ratio_for_planes": 0.05,
                            "remove_voxels_farther_than": 9.0}}
    td, jd = tmaps.map_def_from_yaml("localmap", block, SLOTS), jmaps.map_def_from_yaml("localmap", block, SLOTS)
    assert (td.map_class, td.max_eigen_ratio_for_planes, td.min_distance_between_points) == (
        jd.map_class, jd.max_eigen_ratio_for_planes, jd.min_distance_between_points) == ("NDT", 0.05, 0.2)
    tm, jm = td.create(1.0, 1, "cpu"), jd.create(1.0)
    assert isinstance(tm, tndt.NdtMap) and tm.data.shape[1:] == jm.data.shape
    xyz, valid = _frames(seed=4, n_frames=1)[0]
    tm, ts = tmaps.insert_stats(tm, _tpc(xyz[:1], valid[:1]), layer_def=td)
    jm, js = jax.jit(lambda m, pc: jmaps.insert_stats(m, pc, layer_def=jd))(jm, _jpc(xyz, valid, 0))
    assert int(ts.collision_drops[0]) == int(js.collision_drops)
    center = np.float32([3.0, 1.0, 0.0])
    tm = tmaps.prune_farther_than_amortized(tm, torch.from_numpy(center)[None], 9.0, torch.zeros(1, dtype=torch.int32))
    jm = jax.jit(lambda m, c: jmaps.prune_farther_than_amortized(m, c, 9.0, 0))(jm, jnp.asarray(center))
    _assert_tables(tm, [jm], [])
    tpc, jpc = tmaps.as_pointcloud(tm, 4096, None), jax.jit(lambda m: jmaps.as_pointcloud(m, 4096))(jm)
    np.testing.assert_array_equal(tpc.valid[0].numpy(), np.asarray(jpc.valid))
    np.testing.assert_allclose(tpc.xyz[0].numpy(), np.asarray(jpc.xyz), atol=F32_TOL)
    jm = jm._replace(data=jnp.asarray(tm.data[0].numpy()))
    q = xyz[:1, :500] + np.float32(0.05)
    tv, jv = torch.ones(1, 500, dtype=torch.bool), jnp.ones(500, bool)
    for tquery, jquery in ((tmaps.query_p2p, jmaps.query_p2p), (tmaps.query_p2pl, jmaps.query_p2pl)):
        tq, jq = tquery(tm, torch.from_numpy(q), tv), jax.jit(jquery)(jm, jnp.asarray(q[0]), jv)
        found = np.asarray(jq[-1])
        np.testing.assert_array_equal(tq[-1][0].numpy(), found)
        for got, want in zip(tq[:-1], jq[:-1]):
            np.testing.assert_array_equal(got[0].numpy()[found], np.asarray(want)[found])
    assert not bool(tmaps.is_empty(tm)[0]) and bool(tmaps.is_empty(tmaps.clear(tm))[0])


def test_sym_eigen_smallest_matches_jax():
    """The trigonometric eigenvalues are as well conditioned as the formula
    allows (``arccos`` near +-1 amplifies the last bits of ``det B``): each
    package is within 1e-4 of the entry scale of the float64 truth (JAX's
    float32 result is off by up to 5.8e-5, the port's by 3.0e-5), so the
    two agree within 2e-4.  The normals of plane-like covariances (the ones
    the plane gate passes) are each within 1 - |cos| < 1e-4 of the truth
    (up to 0.014 rad), so they agree within 2e-2 per component, 1e-4 on
    average, with the same sign."""
    rng = np.random.default_rng(5)
    A = rng.normal(0, 1, (4000, 3, 3)).astype(np.float32)
    scale = np.float32([1.0, 0.7, 0.01])  # mostly plane-like spreads
    cov = np.einsum("nij,j,nkj->nik", A, scale, A).astype(np.float32)
    cov6 = np.stack([cov[:, 0, 0], cov[:, 1, 1], cov[:, 2, 2], cov[:, 0, 1], cov[:, 0, 2], cov[:, 1, 2]], -1)
    jv, je3, je2 = (np.asarray(x) for x in jax.jit(jndt._sym_eigen_smallest)(jnp.asarray(cov6)))
    tv, te3, te2 = (x.numpy() for x in tlinalg.sym_eigen_smallest(torch.from_numpy(cov6)))
    truth = np.linalg.eigvalsh(cov.astype(np.float64))
    big = np.abs(cov6).max(-1)
    for got, want in ((te3, truth[:, 0]), (je3, truth[:, 0]), (te2, truth[:, 1]), (je2, truth[:, 1])):
        assert np.abs((got - want) / big).max() < 1e-4
    np.testing.assert_allclose(te3 / big, je3 / big, rtol=0, atol=2e-4)
    np.testing.assert_allclose(te2 / big, je2 / big, rtol=0, atol=2e-4)
    plane = truth[:, 0] <= RATIO * truth[:, 1]
    assert plane.sum() > 1000
    vt = np.linalg.eigh(cov.astype(np.float64))[1][..., 0]
    for v in (tv, jv):
        assert (1.0 - np.abs(np.sum(v * vt, -1)))[plane].max() < 1e-4
    np.testing.assert_allclose(tv[plane], jv[plane], rtol=0, atol=2e-2)
    assert np.abs(tv[plane] - jv[plane]).max(-1).mean() < 1e-4 and np.all(np.sum(tv * jv, -1)[plane] > 0)


def test_point_map_plane_fit_matches_jax():
    """``voxel_hash.p2pl_from`` over a point map's full candidate sets."""
    from mola_lidar_odometry_tpu.ops import voxel_hash as jvh
    from mola_lidar_odometry_tpu_torch.ops import voxel_hash as tvh

    rng = np.random.default_rng(6)
    pts = _scene(rng, 6000, [0.0, 0.0, 0.0])[None]
    tm = tvh.VoxelHashMap.create(1 << 12, 20, 1.0, batch=1, device="cpu")
    tm, _ = tvh.insert_stats(tm, TPC.from_xyz(torch.from_numpy(pts)))
    jm = jvh.VoxelHashMap(jnp.float32(1.0), jnp.asarray(tm.data[0].numpy()), jnp.int32(1), K=tm.K, stride=tm.stride)
    q = _scene(rng, 800, [0.05, 0.02, 0.0])
    tq = tmaps.query_p2pl(tm, torch.from_numpy(q)[None], torch.ones(1, 800, dtype=torch.bool), neighbors=27)
    jq = jax.jit(lambda m, q: jvh.query_p2pl(m, q, jnp.ones(800, bool)))(jm, jnp.asarray(q))
    found = np.asarray(jq[3])
    assert found.sum() > 150
    np.testing.assert_array_equal(tq[3][0].numpy(), found)
    for got, want, tol in zip(tq[:3], jq[:3], (1e-4, 1e-3, 1e-5)):
        np.testing.assert_allclose(got[0].numpy()[found], np.asarray(want)[found], atol=tol)


def test_ndt_local_map_round_trips_between_packages(tmp_path):
    from mola_lidar_odometry_tpu.utils import serialization as jser
    from mola_lidar_odometry_tpu_torch.utils import serialization as tser

    xyz, valid = _frames(seed=8, n_frames=1)[0]
    jm, _ = _j_insert(jndt.NdtMap.create(SLOTS, 0.75, RATIO), _jpc(xyz, valid, 1), min_distance=0.2)
    jser.save_metric_map(tmp_path / "jax.mm", {"localmap": jm})
    tm = tser.load_metric_map(tmp_path / "jax.mm", device="cpu")["localmap"]
    assert isinstance(tm, tndt.NdtMap)
    np.testing.assert_array_equal(tm.data[0].numpy(), np.asarray(jm.data))
    assert (float(tm.voxel_size[0]), float(tm.max_eigen_ratio[0]), int(tm.epoch[0])) == (
        float(jm.voxel_size), float(jm.max_eigen_ratio), int(jm.epoch))
    tm = tndt.prune_farther_than(tm, torch.tensor([[500.0, -300.0, 4.0]]), 5.0)
    tser.save_metric_map(tmp_path / "port.mm", {"localmap": tm})
    back = jser.load_metric_map(tmp_path / "port.mm")["localmap"]
    assert isinstance(back, jndt.NdtMap)
    np.testing.assert_array_equal(np.asarray(back.data), tm.data[0].numpy())
    assert float(back.max_eigen_ratio) == np.float32(RATIO)
