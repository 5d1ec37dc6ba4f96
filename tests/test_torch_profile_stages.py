"""The port's stage split (``apps/profile_stages.py``) against the JAX repo's.

At tiny sizes (raw 4096, ICP 512, map 2048, slots 4096) and B = 1 and 2, the
same ``default_rng(0)`` inputs, drawn in ``eval/profile_stages.py``'s order,
go through each stage as that script calls the JAX package's functions
(``jax.jit``, under ``jax.vmap`` when B > 1, its inputs broadcast; on a CPU
backend its align takes the generic loop, ``use_pallas`` off) and through the
port tool's stage functions on the CPU:

  * the decimated cloud (the winners' order is the decimation's indices),
    the range-filtered and the deskewed clouds, bit for bit;
  * the map-table words after the insert and after the prune, bit for bit;
  * ``query_nn``'s nearest points and found flags bit for bit, its squared
    distances within one ulp of the coordinates (XLA's fused multiply-adds,
    see the test);
  * the Gauss-Newton pose within 1e-5;
  * the forced 10-iteration align: the iteration count equal, the pose
    within 1e-5; and the same with the JAX script's own hook setting, which
    stops after one iteration in both packages (``align_config``).

Last the tool itself runs every stage on the CPU at these sizes."""

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mola_lidar_odometry_tpu_torch.apps import profile_stages as ps

RAW, ICP, MAP, SLOTS = 4096, 512, 2048, 4096
POSE_TOL = 1e-5
ULP_60M = 2.0 ** -18  # the spacing of float32 in [32, 64): the inputs lie in +-60 m


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port steps on one torch thread (the tests run beside others)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_inputs(B):
    """``eval/profile_stages.py``'s inputs and helpers at these sizes."""
    from mola_lidar_odometry_tpu.ops import voxel_hash as vh
    from mola_lidar_odometry_tpu.ops.pointcloud import PointCloud

    rng = np.random.default_rng(0)

    def mb(shape):
        return jnp.asarray(rng.uniform(-60, 60, shape).astype(np.float32))

    vmap = jax.vmap if B > 1 else (lambda f: f)

    def batched(x):
        return jnp.broadcast_to(x, (B,) + x.shape) if B > 1 else x

    raw_pc = PointCloud.from_xyz(mb((RAW, 3)))
    m = vh.VoxelHashMap.create(SLOTS, ps.MAP_K, ps.MAP_VOXEL)
    map_pts = PointCloud.from_xyz(mb((MAP, 3)))
    m = vh.insert(m, map_pts)
    q = mb((ICP, 3))
    qv = jnp.ones(ICP, bool)
    tm = jax.tree_util.tree_map
    return dict(vmap=vmap, raw_pc_b=tm(batched, raw_pc), m_b=tm(batched, m), map_pts_b=tm(batched, map_pts),
                q=q, q_b=batched(q), qv_b=batched(qv), batched=batched)


@pytest.fixture(scope="module", params=[1, 2], ids=["B1", "B2"])
def both(request):
    B = request.param
    return B, _jax_inputs(B), ps.make_inputs(RAW, ICP, MAP, SLOTS, B, "cpu")


def _rows(x, B):
    """A JAX output as (B, ...) numpy (unbatched at B = 1)."""
    a = np.asarray(x)
    return a[None] if B == 1 else a


def _equal_clouds(jpc, tpc, B):
    for f in ("xyz", "time", "intensity", "ring", "valid"):
        np.testing.assert_array_equal(getattr(tpc, f).numpy(), _rows(getattr(jpc, f), B), err_msg=f)


def test_filters_bit_for_bit(both):
    from mola_lidar_odometry_tpu.ops import filters as F

    B, j, t = both
    vmap = j["vmap"]
    dec = jax.jit(vmap(lambda pc: F.decimate_voxels(pc, 0.35, MAP)))(j["raw_pc_b"])
    got = ps.decimate(t)
    assert int(got.valid.sum()) > 0
    _equal_clouds(dec, got, B)
    rng_f = jax.jit(vmap(lambda pc: F.filter_by_range(pc, 1.8, 72.0)[0]))(j["raw_pc_b"])
    _equal_clouds(rng_f, ps.by_range(t), B)
    dsk = jax.jit(vmap(lambda pc: F.deskew(pc, jnp.asarray([8.0, 0, 0, 0, 0, 0.2], jnp.float32))))(j["raw_pc_b"])
    _equal_clouds(dsk, ps.deskew(t), B)


def test_map_insert_and_prune_words(both):
    from mola_lidar_odometry_tpu.ops import voxel_hash as vh

    B, j, t = both
    vmap = j["vmap"]
    np.testing.assert_array_equal(t["map"].data.numpy(), _rows(j["m_b"].data, B))  # the map before the stages
    ins = jax.jit(vmap(vh.insert))(j["m_b"], j["map_pts_b"])
    got = ps.map_insert(t)
    np.testing.assert_array_equal(got.data.numpy(), _rows(ins.data, B))
    assert not torch.equal(got.data, t["map"].data)  # the stage wrote a copy
    prune = jax.jit(vmap(lambda m: vh.prune_farther_than(m, jnp.zeros(3), 100.0)))(j["m_b"])
    got = ps.map_prune(t)
    np.testing.assert_array_equal(got.data.numpy(), _rows(prune.data, B))
    # points within +-60 m lie within 100 m (L-inf) of the centre: the
    # script's prune checks every slot and keeps every voxel
    assert torch.equal(got.data, t["map"].data)


def test_query_nn(both):
    """Nearest points and found flags bit for bit; the squared distances
    within what one unit in the last place of each coordinate moves them:
    XLA contracts the jitted dequantization's scale with the subtraction
    from the query (``fma(a, voxel_size, -q)``, then the sum of squares as
    multiply-adds), which the port, holding each candidate point rounded to
    float32, does not repeat (ROADMAP C4).  A coordinate in [32, 64) m has
    an ulp of 2**-18 m, so ``d2 = |d|^2`` moves by at most ``2 |d| sqrt(3)
    2**-18``."""
    from mola_lidar_odometry_tpu.ops import voxel_hash as vh

    B, j, t = both
    want = jax.jit(j["vmap"](vh.query_nn))(j["m_b"], j["q_b"], j["qv_b"])
    got = ps.query(t)
    assert int(got[2].sum()) > 0
    np.testing.assert_array_equal(got[0].numpy(), _rows(want[0], B))
    np.testing.assert_array_equal(got[2].numpy(), _rows(want[2], B))
    g, w = got[1].numpy(), _rows(want[1], B)
    fin = np.isfinite(w)
    np.testing.assert_array_equal(np.isfinite(g), fin)
    assert np.all(np.abs(g[fin] - w[fin]) <= 2 * np.sqrt(w[fin]) * np.sqrt(3) * ULP_60M)


def test_gauss_newton_pose(both):
    from mola_lidar_odometry_tpu.ops.se3 import Pose
    from mola_lidar_odometry_tpu.ops.solver import PairingBlock, PosePrior, solve_gauss_newton_blocks

    B, j, t = both

    def gn(q, tgt, qv):
        blk = PairingBlock("p2p", q, tgt, jnp.zeros_like(q), qv, 1.0)
        pose, _ = solve_gauss_newton_blocks(Pose.identity(), [blk], 1.0, PosePrior.none(), 2)
        return pose

    want = jax.jit(j["vmap"](gn))(j["q_b"], j["batched"](j["q"] + 0.05), j["qv_b"])
    got = ps.gauss_newton(t)
    np.testing.assert_allclose(got.R.numpy(), _rows(want.R, B), atol=POSE_TOL)
    np.testing.assert_allclose(got.t.numpy(), _rows(want.t, B), atol=POSE_TOL)
    np.testing.assert_allclose(got.t.numpy(), 0.05, atol=1e-3)  # the pose maps each query onto its pair


def test_forced_align(both):
    """The align with the hook's rotation leg off as well (the tool's), then
    with the JAX script's own setting (``hook_min_rot`` 0), which stops
    after one iteration in both packages."""
    from mola_lidar_odometry_tpu.ops import icp as icp_ops
    from mola_lidar_odometry_tpu.ops.se3 import Pose
    from mola_lidar_odometry_tpu.ops.solver import PosePrior
    from mola_lidar_odometry_tpu.utils.expr import Expr

    B, j, t = both
    for hook_min_rot, iterations in ((1e9, ps.ALIGN_ITERATIONS), (0.0, 1)):
        cfg = icp_ops.IcpConfig(
            matchers=(icp_ops.MatcherCfg(threshold=Expr("2.0"), local_layer="icp"),),
            kernel_param=Expr("1.0"),
            max_iterations=10,
            min_abs_step_trans=0.0,
            min_abs_step_rot=0.0,
            hook_min_trans=1e9,
            hook_min_rot=hook_min_rot,
            use_pallas=jax.default_backend() == "tpu",
        )

        def align(m, q, qv, cfg=cfg):
            r = icp_ops.align({"localmap": m}, {"icp": (q, qv)}, Pose.identity(), PosePrior.none(), cfg, {})
            return r.iterations, r.pose

        it, pose = jax.jit(j["vmap"](align))(j["m_b"], j["q_b"], j["qv_b"])
        got = ps.align(t, ps.align_config(hook_min_rot))
        np.testing.assert_array_equal(got.iterations.numpy(), _rows(it, B))
        assert (got.iterations == iterations).all()
        np.testing.assert_allclose(got.pose.R.numpy(), _rows(pose.R, B), atol=POSE_TOL)
        np.testing.assert_allclose(got.pose.t.numpy(), _rows(pose.t, B), atol=POSE_TOL)
        assert float(torch.abs(got.pose.t).max()) > 1e-4  # the pairs moved the pose


def test_tool_runs_every_stage_on_the_cpu():
    out = io.StringIO()
    args = ps.build_parser().parse_args(["--device", "cpu", "--raw", str(RAW), "--icp-cap", str(ICP), "--map-cap",
                                         str(MAP), "--slots", str(SLOTS), "--repeats", "1"])
    rows = ps.run(args, "cpu", out=out)
    assert [r[0].split("(")[0].split(" ")[0] for r in rows] == [
        "decimate_voxels", "filter_by_range", "deskew", "map", "map", "query_nn", "GN", "ICP", "FULL"]
    assert all(ms > 0 and k == {} for _, ms, k in rows)  # the CPU runs the plain twins: no launch counted
    assert len(out.getvalue().splitlines()) == 9
