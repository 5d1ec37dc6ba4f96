"""Port parity of the occupancy map (``ops/occupancy.py``, the map of the
lidar2d pipeline) against the JAX package's, on the CPU: the DDA ray walk,
the slot claim and a three-frame insert bit for bit (keys, used, log-odds
and the match table word for word), the JAX package's ``TestOccupancyMap``
cases (``tests/test_maps.py``), the prune, capture and both queries, and
maps saved by one package loaded by the other.  The inputs are seeded; the
JAX functions run jitted, as its step runs them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mola_lidar_odometry_tpu.ops import occupancy as jocc, voxel_hash as jvh
from mola_lidar_odometry_tpu.ops.occupancy import OccupancyMap as JOcc
from mola_lidar_odometry_tpu.ops.pointcloud import PointCloud as JPC
from mola_lidar_odometry_tpu_torch.ops import maps as tmaps, occupancy as tocc, voxel_hash as tvh
from mola_lidar_odometry_tpu_torch.ops.occupancy import OccupancyMap as TOcc
from mola_lidar_odometry_tpu_torch.ops.pointcloud import PointCloud as TPC


def _rays(seed: int, n: int = 480) -> np.ndarray:
    """Beam endpoints from a sensor at ``ORIGIN``: axis-aligned beams,
    negative directions, a zero component, beams shorter than one voxel and
    beams longer than the step budget."""
    rs = np.random.default_rng(seed)
    d = rs.uniform(-1.0, 1.0, (n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    r = rs.uniform(0.5, 12.0, n)
    k = n // 6
    d[:k] = np.eye(3)[rs.integers(0, 3, k)] * rs.choice([-1.0, 1.0], (k, 1))  # axis-aligned, both signs
    d[k : 2 * k, 2] = 0.0  # a zero component (a 2D scan)
    r[2 * k : 3 * k] = rs.uniform(0.0, 0.2, k)  # shorter than one voxel
    r[3 * k : 4 * k] = rs.uniform(40.0, 60.0, k)  # past the step budget
    return (ORIGIN + d * r[:, None]).astype(np.float32)


ORIGIN = np.array([0.13, -0.27, 0.31], np.float32)
V = 1 << 12


def _t(a, dtype=None):
    return torch.as_tensor(np.asarray(a), dtype=dtype)[None]


def _tpc(xyz, valid=None):
    return TPC.from_xyz(_t(xyz, torch.float32), valid=None if valid is None else _t(valid, torch.bool))


def _jpc(xyz, valid=None):
    return JPC.from_xyz(jnp.asarray(xyz), valid=None if valid is None else jnp.asarray(valid))


_jinsert = jax.jit(lambda m, pc, o=None, **kw: jocc.insert_stats(m, pc, o, **kw)[0],
                   static_argnames=("ray_trace", "max_ray_samples"))


def _assert_maps_equal(t: TOcc, j: JOcc):
    for f in ("voxel_size", "keys", "used", "logodds", "l_hit", "l_miss", "l_min", "l_max", "l_occ"):
        np.testing.assert_array_equal(getattr(t, f)[0].numpy(), np.asarray(getattr(j, f)), err_msg=f)
    np.testing.assert_array_equal(t.match.data[0].numpy(), np.asarray(j.match.data), err_msg="match table")
    assert int(t.match.epoch[0]) == int(j.match.epoch)


def test_dda_walk_matches_jax_bit_for_bit():
    rays = _rays(0)
    valid = np.random.default_rng(1).random(len(rays)) > 0.1
    for vs, steps in ((0.05, 64), (0.25, 32), (0.3, 48)):
        jc, je = jax.jit(jocc._dda_voxels, static_argnums=4)(
            jnp.asarray(ORIGIN), jnp.asarray(rays), jnp.asarray(valid), jnp.float32(vs), steps)
        tc, te = tocc._dda_voxels(_t(ORIGIN), _t(rays), _t(valid), torch.tensor([vs]), steps)
        np.testing.assert_array_equal(tc[0].numpy(), np.asarray(jc))
        np.testing.assert_array_equal(te[0].numpy(), np.asarray(je))
        assert np.asarray(je)[-1].any() and not np.asarray(je)[-1].all()  # some beams outrun the budget


def test_claim_slots_matches_jax():
    rs = np.random.default_rng(2)
    n, slots = 3000, 256  # crowded: many claims race for one slot
    coords = rs.integers(-20, 20, (n, 3)).astype(np.int32)
    slot = rs.integers(0, slots, n).astype(np.int32)
    valid, occupied, same = (rs.random(n) > p for p in (0.1, 0.7, 0.5))
    ja, jc = jvh.claim_slots(*(jnp.asarray(a) for a in (same, occupied, coords, slot, valid)), slots)
    ta, tc = tvh.claim_slots(*(_t(a) for a in (same, occupied, coords, slot, valid)), slots)
    np.testing.assert_array_equal(ta[0].numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tc[0].numpy(), np.asarray(jc))
    assert 0 < int(tc.sum()) < int(ta.sum())


@pytest.mark.parametrize("ray_trace", [True, False], ids=["ray-trace", "hits-only"])
def test_insert_three_frames_word_for_word(ray_trace):
    """Three scans from three sensor positions into one 0.25 m map (log-odds
    summed over frames, slots claimed and lost, the match index rebuilt each
    time), then a prune."""
    j_ins = jax.jit(lambda m, pc, o: jocc.insert_stats(m, pc, o, ray_trace=ray_trace, max_ray_samples=96))
    jm, tm = JOcc.create(V, 0.25), TOcc.create(V, 0.25, 1, "cpu")
    for k in range(3):
        origin = ORIGIN + np.float32(0.4 * k)
        pts = _rays(10 + k) + np.float32(0.4 * k)
        valid = np.random.default_rng(20 + k).random(len(pts)) > 0.05
        jm, jst = j_ins(jm, _jpc(pts, valid), jnp.asarray(origin))
        tm, tst = tocc.insert_stats(tm, _tpc(pts, valid), _t(origin), ray_trace=ray_trace, max_ray_samples=96)
        _assert_maps_equal(tm, jm)
        assert [int(v[0]) for v in tst] == [int(v) for v in jst]
    assert int(tm.num_voxels()[0]) > 5 and int(tm.used.sum()) > 500
    jm = jax.jit(jocc.prune_farther_than)(jm, jnp.asarray(ORIGIN), jnp.float32(5.0))
    tm = tocc.prune_farther_than(tm, _t(ORIGIN), 5.0)
    _assert_maps_equal(tm, jm)


def test_hits_and_free_space():
    """``TestOccupancyMap.test_hits_and_free_space``: a wall at x = 5 seen
    from the origin; both packages' maps equal, the wall occupied, the mid
    beam free."""
    ys = np.linspace(-2, 2, 100).astype(np.float32)
    pts = np.stack([np.full(100, 5.0, np.float32), ys, np.zeros(100, np.float32)], 1)
    jm = _jinsert(JOcc.create(1 << 14, 0.25), _jpc(pts), jnp.zeros(3), max_ray_samples=128)
    tm, _ = tocc.insert_stats(TOcc.create(1 << 14, 0.25, 1, "cpu"), _tpc(pts), torch.zeros(1, 3),
                              max_ray_samples=128)
    _assert_maps_equal(tm, jm)
    assert int(tm.num_voxels()[0]) > 10
    q = np.asarray([[5.0, 0.0, 0.0], [2.5, 0.0, 0.0]], np.float32)
    tgt, d2, found = tocc.query_p2p(tm, _t(q), torch.ones(1, 2, dtype=torch.bool))
    assert bool(found[0, 0]) and float(d2[0, 0]) < 0.1
    if bool(found[0, 1]):
        assert float(d2[0, 1]) > 2.0**2


def test_repeated_miss_does_not_occupy():
    """``TestOccupancyMap.test_repeated_miss_does_not_occupy``: five inserts
    of one beam leave only its endpoint occupied; the log-odds clamp at
    ``logit(0.95)`` in both packages."""
    pts = np.asarray([[4.0, 0.0, 0.0]], np.float32)
    jm, tm = JOcc.create(V, 0.25), TOcc.create(V, 0.25, 1, "cpu")
    for _ in range(5):
        jm = _jinsert(jm, _jpc(pts), jnp.zeros(3), max_ray_samples=128)
        tm, _ = tocc.insert_stats(tm, _tpc(pts), torch.zeros(1, 3), max_ray_samples=128)
    _assert_maps_equal(tm, jm)
    keys = tm.keys[0][tm.occupied()[0]]
    assert keys.shape[0] >= 1 and bool(torch.all(keys[:, 0] >= 15))
    assert float(tm.logodds.max()) == float(tm.l_max[0])


def test_prune():
    """``TestOccupancyMap.test_prune``, through ``ops/maps.py`` as the step
    calls it; the occupied centers as a point view."""
    pts = np.stack([np.linspace(0, 30, 60)] * 3, 1).astype(np.float32)
    jm = _jinsert(JOcc.create(V, 0.5), _jpc(pts), ray_trace=False)
    d = tmaps.MapLayerDef(map_class="CVoxelMap", num_slots=V)
    tm = tmaps.set_voxel_size(d.create(1.0, 1, "cpu"), 0.5)
    tm, _ = tmaps.insert_stats(tm, _tpc(pts), None, tmaps.MapLayerDef(map_class="CVoxelMap",
                                                                       ray_trace_free_space=False))
    n0 = int(tm.num_voxels()[0])
    jm = jocc.prune_farther_than(jm, jnp.zeros(3), 10.0)
    tm = tmaps.prune_farther_than(tm, torch.zeros(1, 3), 10.0)
    _assert_maps_equal(tm, jm)
    assert int(tm.num_voxels()[0]) < n0
    pc = tmaps.as_pointcloud(tm, 64, torch.zeros(1, 3))
    assert int(pc.count()[0]) == int(tm.num_voxels()[0])
    assert bool(torch.all(torch.abs(pc.xyz[0][pc.valid[0]]) <= 10.0 + 0.25))


def test_capture_and_queries_match_jax():
    pts = _rays(30)
    jm = _jinsert(JOcc.create(V, 0.25), _jpc(pts), jnp.asarray(ORIGIN), max_ray_samples=96)
    tm, _ = tocc.insert_stats(TOcc.create(V, 0.25, 1, "cpu"), _tpc(pts), _t(ORIGIN), max_ray_samples=96)
    q = (pts + np.random.default_rng(31).normal(0.0, 0.3, pts.shape)).astype(np.float32)
    qv = np.random.default_rng(32).random(len(q)) > 0.1
    jc, tc = jocc.capture(jm, jnp.asarray(q)), tocc.capture(tm, _t(q))
    np.testing.assert_array_equal(tc.pts[0].numpy(), np.asarray(jc.pts))
    np.testing.assert_array_equal(tc.mask[0].numpy(), np.asarray(jc.mask))
    for jq, tq in ((jocc.query_p2p, tocc.query_p2p), (jocc.query_p2p2, tmaps.query_p2p2)):
        jr, tr = jq(jm, jnp.asarray(q), jnp.asarray(qv)), tq(tm, _t(q), _t(qv))
        for a, b in zip(tr, jr):
            np.testing.assert_array_equal(a[0].numpy(), np.asarray(b))
    assert int(tr[2][0].all(-1).sum()) > 100


def test_maps_saved_by_one_package_load_in_the_other(tmp_path):
    """The port's ``.mm.npz`` holds the JAX field names: the JAX package's
    loader reads keys, used, log-odds and the scalars from it word for word.
    A file with the JAX map's fields (the JAX ``save_metric_map`` cannot
    write its nested match index, ROADMAP C9), with and without the match
    arrays, loads into the port equal to the JAX map."""
    from mola_lidar_odometry_tpu.utils import serialization as jser
    from mola_lidar_odometry_tpu_torch.utils import serialization as tser

    pts = _rays(40)
    jm = _jinsert(JOcc.create(V, 0.25), _jpc(pts), jnp.asarray(ORIGIN), max_ray_samples=96)
    tm, _ = tocc.insert_stats(TOcc.create(V, 0.25, 1, "cpu"), _tpc(pts), _t(ORIGIN), max_ray_samples=96)
    tser.save_metric_map(tmp_path / "port.mm", {"localmap": tm})
    back = jser.load_metric_map(tmp_path / "port.mm")["localmap"]
    for f in ("voxel_size", "keys", "used", "logodds", "l_hit", "l_miss", "l_min", "l_max", "l_occ"):
        np.testing.assert_array_equal(np.asarray(getattr(back, f)), np.asarray(getattr(jm, f)), err_msg=f)
    _assert_maps_equal(tser.load_metric_map(tmp_path / "port.mm", device="cpu")["localmap"], jm)

    fields = {f"localmap/{f}": np.asarray(getattr(jm, f)) for f in JOcc._fields if f != "match"}
    match = {f"localmap/match/{f}": np.asarray(getattr(jm.match, f)) for f in ("voxel_size", "data", "epoch")}
    meta = {"localmap": {"kind": "OccupancyMap", "match": {"K": jm.match.K, "stride": jm.match.stride}}}
    import json

    np.savez(tmp_path / "jax.mm.npz", __meta__=json.dumps(meta), **fields, **match)
    _assert_maps_equal(tser.load_metric_map(tmp_path / "jax.mm.npz", device="cpu")["localmap"], jm)
    np.savez(tmp_path / "jax_nomatch.mm.npz", __meta__=json.dumps(meta), **fields)
    rebuilt = tser.load_metric_map(tmp_path / "jax_nomatch.mm.npz", device="cpu")["localmap"]
    np.testing.assert_array_equal(rebuilt.logodds[0].numpy(), np.asarray(jm.logodds))
    q = _t(pts)
    for a, b in zip(tocc.query_p2p(rebuilt, q, torch.ones(1, len(pts), dtype=torch.bool)),
                    tocc.query_p2p(tm, q, torch.ones(1, len(pts), dtype=torch.bool))):
        assert torch.equal(a, b)  # the rebuilt index serves the same nearest centers
