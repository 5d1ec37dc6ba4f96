"""Port parity of the point map at every window the JAX package creates, and
of its ``min_distance_between_points`` dedup.

  * At K in {30, 62, 64, 126, 127, 200, 254} points per voxel (full 32-,
    64- and 128-lane windows, a 128-lane window with room, and 256-lane
    windows that span two rows), the port's create, a two-frame insert
    (with the budget, an epoch clear, and the dedup on the second frame),
    the rolling-slab and whole-table prunes, the epoch-wrap slab zeroing,
    the capture (all candidates and the per-voxel top-2), ``as_pointcloud``
    and the npz and MRPT map files hold the JAX package's results word for
    word.
  * The dedup mirrors ``tests/test_voxel_hash.py``'s
    ``TestMinDistanceBetweenPoints`` and ``TestInsertBudget.test_defers_and_converges``
    on both packages, with and without the budget.
  * lidar3d-default at K = 64 (stride 128, the fused path on the plain
    twins of kernels B1-B3) steps 4 frames through both packages'
    ``LidarOdometry`` at the family gate of ``test_torch_family_ndt.step_both``.
    The K = 200 map with the dedup (the generic loop) is in
    ``test_torch_windows_dedup_pipeline.py``: each file compiles one JAX step.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mola_lidar_odometry_tpu.ops import voxel_hash as jvh
from mola_lidar_odometry_tpu.ops.pointcloud import PointCloud as JPC
from mola_lidar_odometry_tpu_torch.ops import voxel_hash as tvh
from mola_lidar_odometry_tpu_torch.ops.pointcloud import PointCloud as TPC

HERE = os.path.dirname(os.path.abspath(__file__))
SLOTS = 1 << 11
# the JAX package's functions compiled whole (eager dispatch compiles each
# primitive anew at every new shape, and every K brings new shapes)
_j_insert = jax.jit(jvh.insert_stats, static_argnames=("min_distance", "budget"))
_j_capture = jax.jit(jvh.capture, static_argnames=("neighbors", "per_voxel_nn"))
_j_query = {f: jax.jit(getattr(jvh, f)) for f in ("query_nn", "query_nn2", "query_p2pl")}
_j_points = jax.jit(jvh.as_pointcloud, static_argnames=("capacity",))
_j_anchor = jax.jit(jvh.derive_anchor_vox)
_j_slab = jax.jit(jvh.prune_farther_than_slab, static_argnames=("n_slabs",))
_j_prune = jax.jit(jvh.prune_farther_than)
_j_zero = jax.jit(jvh.zero_state_slab, static_argnames=("n_slabs",))


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _frame(rng, n=3000):
    """Points around the origin: a dense clump (full voxels), a ground
    plane (planes to fit) and a few invalid ones."""
    ground = np.concatenate([rng.uniform(-3, 3, (n // 3, 2)), rng.normal(-1.2, 0.01, (n // 3, 1))], axis=1)
    xyz = np.concatenate([rng.uniform((-3, -3, 0), (3, 3, 3), (n // 3, 3)), ground, rng.normal(0.75, 0.12, (n - 2 * (n // 3), 3))])
    return xyz.astype(np.float32), rng.random(n) > 0.05


def _insert_both(tm, jm, xyz, valid, **kw):
    tm, ts = tvh.insert_stats(tm, TPC.from_xyz(torch.from_numpy(xyz)[None], valid=torch.from_numpy(valid)[None]), **kw)
    jm, js = _j_insert(jm, JPC.from_xyz(jnp.asarray(xyz), valid=jnp.asarray(valid)), **kw)
    assert [int(x[0]) for x in ts] == [int(js.collision_drops), int(js.full_drops), int(js.deferred_drops)]
    np.testing.assert_array_equal(tm.data[0].numpy(), np.asarray(jm.data))
    return tm, jm, ts


@pytest.mark.parametrize("K", [30, 62, 64, 126, 127, 200, 254])
def test_windows_word_for_word(K, tmp_path):
    from mola_lidar_odometry_tpu.utils import serialization as jser
    from mola_lidar_odometry_tpu_torch.utils import serialization as tser

    rng = np.random.default_rng(K)
    tm = tvh.VoxelHashMap.create(SLOTS, K, 0.5, 1, "cpu")
    jm = jvh.VoxelHashMap.create(SLOTS, K, 0.5)
    assert (tm.stride, tm.K, tuple(tm.data.shape[1:])) == (jm.stride, jm.K, tuple(jm.data.shape))
    xyz, valid = _frame(rng)
    tm, jm, ts = _insert_both(tm, jm, xyz, valid, budget=1000)
    assert int(ts.deferred_drops[0]) > 0
    tm, jm = tm.clear(), jm.clear()
    tm, jm, _ = _insert_both(tm, jm, *_frame(rng), budget=1000)
    tm, jm, ts = _insert_both(tm, jm, *_frame(rng), min_distance=0.05)
    # voxels filled to K: a full window's last lane holds a point
    full = int((tm.count() == K).sum())
    assert full > 0, full
    if 2 + K == tm.stride:
        assert int((tm.windows()[0, :, -1] != 0).sum()) > 0

    queries = (xyz[800:1200] + rng.normal(0, 0.05, (400, 3))).astype(np.float32)
    for per_voxel in (False, True):
        tc = tvh.capture(tm, torch.from_numpy(queries)[None], 27, per_voxel_nn=per_voxel)
        jc = _j_capture(jm, jnp.asarray(queries), 27, per_voxel_nn=per_voxel)
        np.testing.assert_array_equal(tc.mask[0].numpy(), np.asarray(jc.mask))
        np.testing.assert_array_equal(tc.pts[0].numpy(), np.asarray(jc.pts))
    tq, jq = torch.from_numpy(queries)[None], jnp.asarray(queries)
    tv, jv = torch.ones((1, 400), dtype=torch.bool), jnp.ones(400, bool)
    for f in ("query_nn", "query_nn2"):  # XLA fuses the jitted d2 sums (a last-bit difference)
        for t, j in zip(getattr(tvh, f)(tm, tq, tv), _j_query[f](jm, jq, jv)):
            np.testing.assert_allclose(t[0].numpy(), np.asarray(j), rtol=1e-6, atol=0)
    # the plane fit: XLA rounds its closed-form eigen solve its own way
    # (ROADMAP C11), so the planes found are held to 1e-4
    tpl, jpl = tvh.query_p2pl(tm, tq, tv), _j_query["query_p2pl"](jm, jq, jv)
    found = np.asarray(jpl[3])
    np.testing.assert_array_equal(tpl[3][0].numpy(), found)
    assert found.sum() > 50
    for t, j in zip(tpl[:3], jpl[:3]):
        np.testing.assert_allclose(t[0].numpy()[found], np.asarray(j)[found], rtol=1e-4, atol=1e-4)

    cap = tm.num_slots * K
    tp, jp = tvh.as_pointcloud(tm, cap), _j_points(jm, cap)
    np.testing.assert_array_equal(tp.valid[0].numpy(), np.asarray(jp.valid))
    np.testing.assert_array_equal(tp.xyz[0].numpy(), np.asarray(jp.xyz))
    np.testing.assert_array_equal(tvh.derive_anchor_vox(tm)[0].numpy(), np.asarray(_j_anchor(jm)))

    # the map files: the port's npz read by the JAX package; its MRPT file
    # read back holds the JAX package's point view
    tser.save_metric_map(tmp_path / "port.mm", {"localmap": tm})
    back = jser.load_metric_map(tmp_path / "port.mm")["localmap"]
    assert (back.K, back.stride) == (K, tm.stride)
    np.testing.assert_array_equal(np.asarray(back.data), np.asarray(jm.data))
    again = tser.load_metric_map(tmp_path / "port.mm", device="cpu")["localmap"]
    assert torch.equal(again.data, tm.data) and (again.K, again.stride) == (K, tm.stride)
    tser.export_metric_map_mrpt(tmp_path / "port_mrpt.mm", {"localmap": tm}, capacity=cap)
    tpts = tser.import_metric_map_mrpt(tmp_path / "port_mrpt.mm")["localmap"]
    np.testing.assert_array_equal(tpts, np.asarray(jp.xyz)[np.asarray(jp.valid)])
    assert len(tpts) == int(tm.num_points()[0])

    # the prunes: the rolling slab, the whole table, the epoch-wrap zeroing
    center = np.array([1.0, -1.0, 0.0], np.float32)
    for slab in (3, 10):
        tm = tvh.prune_farther_than_slab(tm, torch.from_numpy(center)[None], 2.0, torch.tensor([slab]), n_slabs=16)
        jm = _j_slab(jm, jnp.asarray(center), 2.0, jnp.int32(slab), n_slabs=16)
        np.testing.assert_array_equal(tm.data[0].numpy(), np.asarray(jm.data))
    tm = tvh.prune_farther_than(tm, torch.from_numpy(center)[None], 3.0)
    jm = _j_prune(jm, jnp.asarray(center), 3.0)
    np.testing.assert_array_equal(tm.data[0].numpy(), np.asarray(jm.data))
    assert 0 < int(tm.num_points()[0]) < len(tpts)
    tm = tvh.zero_state_slab(tm, torch.tensor([5]), n_slabs=8)
    jm = _j_zero(jm, jnp.int32(5), n_slabs=8)
    np.testing.assert_array_equal(tm.data[0].numpy(), np.asarray(jm.data))


@pytest.mark.parametrize("budget", [0, 64])
def test_min_distance_matches_jax(budget):
    """``TestMinDistanceBetweenPoints`` (a 5 cm neighbour refused, a 30 cm
    one stored, neither counted as a collision; off by default) and
    ``test_defers_and_converges`` (re-presenting one cloud with the dedup
    converges to the unbudgeted insert) on both packages, word for word."""
    kw = dict(budget=budget)
    tm = tvh.VoxelHashMap.create(1 << 8, 8, 1.0, 1, "cpu")
    jm = jvh.VoxelHashMap.create(1 << 8, 8, 1.0)
    one = np.ones(1, bool)
    tm, jm, _ = _insert_both(tm, jm, np.array([[0.50, 0.50, 0.50]], np.float32), one, min_distance=0.2, **kw)
    tn, _, st = _insert_both(tm._replace(data=tm.data.clone()), jm, np.array([[0.55, 0.5, 0.5]], np.float32), one,
                             min_distance=0.2, **kw)
    assert int(tn.num_points()[0]) == 1 and int(st.collision_drops[0]) == 0
    tf, _, _ = _insert_both(tm._replace(data=tm.data.clone()), jm, np.array([[0.80, 0.5, 0.5]], np.float32), one,
                            min_distance=0.2, **kw)
    assert int(tf.num_points()[0]) == 2
    pair = np.array([[0.50, 0.50, 0.50], [0.52, 0.50, 0.50]], np.float32)
    td, _, _ = _insert_both(tvh.VoxelHashMap.create(1 << 8, 8, 1.0, 1, "cpu"), jvh.VoxelHashMap.create(1 << 8, 8, 1.0),
                            pair, np.ones(2, bool), **kw)
    assert int(td.num_points()[0]) == 2  # off by default, and one batch's points do not see each other

    rng = np.random.default_rng(7)
    pts = rng.uniform(-10, 10, (400, 3)).astype(np.float32)
    ref, _, _ = _insert_both(tvh.VoxelHashMap.create(512, 4, 1.0, 1, "cpu"), jvh.VoxelHashMap.create(512, 4, 1.0),
                             pts, np.ones(400, bool), min_distance=1e-3)
    tm, jm = tvh.VoxelHashMap.create(512, 4, 1.0, 1, "cpu"), jvh.VoxelHashMap.create(512, 4, 1.0)
    prev = 0
    for _ in range(8 if budget else 2):
        tm, jm, _ = _insert_both(tm, jm, pts, np.ones(400, bool), min_distance=1e-3, **kw)
        now = int(tm.num_points()[0])
        assert now - prev <= (budget or 400)
        prev = now
    assert now == int(ref.num_points()[0])
    np.testing.assert_array_equal(tm.count()[0].numpy(), ref.count()[0].numpy())


def yaml_copy(tmp_path, K: int, min_distance: float = 0.0) -> str:
    """pipelines/lidar3d-default.yaml with ``max_points_per_voxel`` and
    ``min_distance_between_points`` set, written into ``tmp_path`` (the
    repo's pipelines stay as they are)."""
    with open(os.path.join(HERE, "..", "pipelines", "lidar3d-default.yaml")) as f:
        text = f.read()
    for old, new in (("${MOLA_LOCALMAP_MAX_POINTS_PER_VOXEL|20}", str(K)),
                     ("min_distance_between_points: 0\n", f"min_distance_between_points: {min_distance}\n")):
        assert text.count(old) == 1, old
        text = text.replace(old, new)
    path = tmp_path / f"lidar3d-default-K{K}.yaml"
    path.write_text(text)
    return str(path)


def test_fused_path_at_k64_matches_jax(tmp_path):
    """lidar3d-default with 64 points per voxel: a 128-lane window, which
    the fused path (the plain twins of B1-B3 on the CPU) takes in both
    packages; 4 frames at the family gate."""
    from test_torch_family_kissicp_nearfar import FUSED
    from test_torch_family_ndt import step_both

    from mola_lidar_odometry_tpu_torch.ops import icp as ticp

    _, _, _, touts, jlo, tlo = step_both(yaml_copy(tmp_path, 64), FUSED, frames=4,
                                         scan_kw=dict(n_rings=16, n_azimuth=512))
    m = tlo.carry.maps["localmap"]
    assert (m.K, m.stride) == (64, 128) and ticp._fused_eligible(tlo.spec.icp_with_vel)
    assert tlo.spec.layer_capacities == jlo.spec.layer_capacities
    assert all(bool(o.accepted) for o in touts)
