"""Port parity for the generic ICP align loop: ``ops/icp.py::align`` of
mola_lidar_odometry_tpu_torch, for configurations outside the fused path,
against the JAX package's ``icp.align``.

The port runs a fleet of B=3 instances in one batched loop; their entry
poses differ (2 cm, 10 cm and 27 cm off the answer) so that their iteration
counts differ and, where the twist hook is on, the last one stops on it.
The JAX reference runs once per instance with ``use_pallas=False,
per_voxel_nn=True``: the XLA twin of its ``nn_select`` kernel (the JAX
package's own ``test_nn_select_matches_xla_path`` ties the two), compiled
once per case.

Gate, as for the fused kernel: pose within 3e-3, iterations within one,
quality within 0.02, the same ``hook_stop`` and ``converged`` flags.  Horn
and Anderson amplify rounding, so only the final state is compared.  The
shipped pipelines' generic-loop configurations are held against the JAX
package's in ``test_torch_generic_configs.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mola_lidar_odometry_tpu.ops import icp as jicp, se3 as jse3, voxel_hash as jvh
from mola_lidar_odometry_tpu.ops.se3 import Pose as JPose
from mola_lidar_odometry_tpu.ops.solver import PosePrior as JPrior
from mola_lidar_odometry_tpu.utils.expr import Expr as JExpr
from mola_lidar_odometry_tpu_torch.ops import icp as ticp, pallas_match as tpm, voxel_hash as tvh
from mola_lidar_odometry_tpu_torch.ops.pointcloud import PointCloud as TPC
from mola_lidar_odometry_tpu_torch.ops.se3 import Pose as TPose
from mola_lidar_odometry_tpu_torch.ops.solver import PosePrior as TPrior
from mola_lidar_odometry_tpu_torch.utils.expr import Expr as TExpr

B = 3
ANNEAL = "SIG*max(1.0, 2.0-(1.5)*ICP_ITERATION/10)"
HOOK = dict(hook_min_trans=0.15, hook_min_rot=0.0131)


def _world(seed=0, n=3000):
    rng = np.random.default_rng(seed)
    g = rng.uniform(-15, 15, (n, 2)).astype(np.float32)
    floor = np.stack([g[:, 0], g[:, 1], np.zeros(n, np.float32)], 1)
    w1 = np.stack([g[: n // 2, 0], np.full(n // 2, 8.0, np.float32), rng.uniform(0, 4, n // 2).astype(np.float32)], 1)
    w2 = np.stack([np.full(n // 2, -6.0, np.float32), g[n // 2 :, 1], rng.uniform(0, 4, n // 2).astype(np.float32)], 1)
    return np.concatenate([floor, w1, w2]).astype(np.float32)


@pytest.fixture(scope="module")
def scene():
    """Two maps of one world (K=20 and K=10, as the dual-map pipeline), two
    local layers (400 and 250 points) seen from a true pose, three entry
    poses, a prior on instance 1 and a per-instance sigma."""
    pts = _world()
    jmaps, tmaps = {}, {}
    for name, K in (("localmap", 20), ("localmap_far", 10)):
        tm = tvh.VoxelHashMap.create(1 << 13, K, 1.0, batch=B, device="cpu")
        tmaps[name], _ = tvh.insert_stats(tm, TPC.from_xyz(torch.from_numpy(np.stack([pts] * B))))
        # the JAX map takes the port's table: the layout is shared word for word
        # (tests/test_torch_step_dualmap.py holds the two inserts against each other)
        jmaps[name] = jvh.VoxelHashMap.create(1 << 13, K, 1.0)._replace(data=jnp.asarray(tmaps[name].data[0].numpy()))
        assert (jmaps[name].K, jmaps[name].stride) == (tmaps[name].K, tmaps[name].stride)
    rng = np.random.default_rng(1)
    true_pose = JPose(
        jse3.so3_exp(jnp.asarray([0.004, -0.006, 0.02], jnp.float32)), jnp.asarray([0.15, -0.08, 0.02], jnp.float32)
    )
    inv = JPose(true_pose.R.T, -true_pose.R.T @ true_pose.t)
    layers = {}
    for name, n in (("icp", 400), ("icp_near", 250)):
        sel = rng.choice(len(pts), n, replace=False)
        world_q = jnp.asarray(pts[sel] + rng.normal(0, 0.01, (n, 3)).astype(np.float32))
        valid = np.ones((n,), bool)
        valid[::13] = False
        layers[name] = (np.asarray(jse3.transform(inv, world_q)), valid)
    off = np.array([[0.02, 0.0, 0.0, 0, 0, 0.001], [-0.06, 0.08, 0.01, 0.002, 0, -0.004],
                    [0.25, -0.1, 0.0, 0, 0, 0.0]], np.float32)
    entry = [jse3.compose(jse3.se3_exp(jnp.asarray(x)), true_pose) for x in off]
    entry_R = np.stack([np.asarray(P.R) for P in entry])
    entry_t = np.stack([np.asarray(P.t) for P in entry])
    info = np.zeros((B, 6, 6), np.float32)
    info[1] = np.diag([4.0, 4.0, 4.0, 9.0, 9.0, 9.0])
    prior_R = np.stack([np.asarray(jse3.so3_exp(jnp.asarray([0.1, -0.2, 0.15], jnp.float32)))] * B)
    prior_t = np.array([[0.0, 0.0, 0.0], [0.2, -0.1, 0.0], [0.0, 0.0, 0.0]], np.float32)
    sig = np.array([1.0, 1.2, 1.0], np.float32)
    return dict(jmaps=jmaps, tmaps=tmaps, layers=layers, entry_R=entry_R, entry_t=entry_t, info=info,
                prior_R=prior_R, prior_t=prior_t, sig=sig)


def _matcher(mod, E, **kw):
    kw.setdefault("threshold", E("2.0*" + ANNEAL))
    kw.setdefault("local_layer", "icp")
    return mod.MatcherCfg(**kw)


def _case(name):
    """(matcher kwargs list, IcpConfig kwargs, per-instance budget or None)."""
    two = [dict(), dict(local_layer="icp_near", global_layer="localmap_far", threshold="1.5*" + ANNEAL, weight=0.7)]
    cases = {
        "dual-map": (two, dict(nn_neighbors=27, max_iterations=40, **HOOK), None),
        "run-from-up-to": (
            [dict(run_up_to_iteration=5), dict(two[1], run_from_iteration=3)],
            dict(nn_neighbors=27, max_iterations=40, **HOOK), None,
        ),
        "one-to-one": ([dict(allow_match_already_matched=False)], dict(nn_neighbors=8, max_iterations=40, **HOOK), None),
        "two-pairings": ([dict(pairings_per_point=2)], dict(nn_neighbors=8, max_iterations=40, **HOOK), None),
        "angular-threshold": (
            [dict(threshold_angular_deg=0.5, threshold="0.3*" + ANNEAL)],
            dict(nn_neighbors=8, max_iterations=40, **HOOK), None,
        ),
        "horn-no-hook": ([dict()], dict(nn_neighbors=8, max_iterations=25, horn=True), None),
        "anderson": (two, dict(nn_neighbors=27, max_iterations=40, anderson_m=3, **HOOK), None),
        "traced-budget": (two, dict(nn_neighbors=27, max_iterations=40, **HOOK), [3, 40, 1]),
    }
    return cases[name]


def _cfg(mod, E, matchers, kw, **extra):
    kw = dict(kw)
    if kw.pop("horn", False):
        kw["horn"] = mod.HornCfg(run_until_translation_correction_smaller_than=5e-3)
    ms = []
    for m in matchers:
        m = dict(m)
        if "threshold" in m:
            m["threshold"] = E(m["threshold"])
        ms.append(_matcher(mod, E, **m))
    return mod.IcpConfig(matchers=tuple(ms), kernel_param=E("0.5*" + ANNEAL), **kw, **extra)


def _align_both(s, matchers, kw, budget=None):
    """The port's batched align and the JAX align per instance, held to the
    gate of the module docstring; returns (the port's result, JAX's
    iteration counts)."""
    jcfg = _cfg(jicp, JExpr, matchers, kw, use_pallas=False, per_voxel_nn=True)
    tcfg = _cfg(ticp, TExpr, matchers, kw)
    assert not ticp._fused_eligible(tcfg) or tcfg.hook_min_trans == 0  # the generic loop, not the fused path
    T = torch.from_numpy
    tlayers = {k: (T(np.stack([x] * B)), T(np.stack([v] * B))) for k, (x, v) in s["layers"].items()}
    launches = tpm.nn_select.launches
    res = ticp.align(
        s["tmaps"], tlayers, TPose(T(s["entry_R"]), T(s["entry_t"])),
        TPrior(TPose(T(s["prior_R"]), T(s["prior_t"])), T(s["info"])), tcfg, {"SIG": T(s["sig"])},
        None if budget is None else T(np.asarray(budget, np.int32)),
    )
    assert tpm.nn_select.launches == launches  # CPU tensors: the plain twin, no launch counted

    jlayers = {k: (jnp.asarray(x), jnp.asarray(v)) for k, (x, v) in s["layers"].items()}

    @jax.jit
    def ref(eR, et, pR, pt, info, sig, bud):
        return jicp.align(s["jmaps"], jlayers, JPose(eR, et), JPrior(JPose(pR, pt), info), jcfg, {"SIG": sig}, bud)

    its = []
    for b in range(B):
        bud = jnp.int32(kw["max_iterations"] if budget is None else budget[b])
        r = ref(s["entry_R"][b], s["entry_t"][b], s["prior_R"][b], s["prior_t"][b], s["info"][b], s["sig"][b], bud)
        np.testing.assert_allclose(res.pose.R[b].numpy(), np.asarray(r.pose.R), atol=3e-3, err_msg=f"R[{b}]")
        np.testing.assert_allclose(res.pose.t[b].numpy(), np.asarray(r.pose.t), atol=3e-3, err_msg=f"t[{b}]")
        assert abs(int(res.iterations[b]) - int(r.iterations)) <= 1, (b, res.iterations, r.iterations)
        assert abs(float(res.quality[b]) - float(r.quality)) < 0.02, (b, res.quality, r.quality)
        assert bool(res.hook_stop[b]) == bool(r.hook_stop), (b, "hook_stop")
        assert bool(res.converged[b]) == bool(r.converged), (b, "converged")
        its.append(int(r.iterations))
    return res, its


@pytest.mark.parametrize(
    "name",
    ["dual-map", "run-from-up-to", "one-to-one", "two-pairings", "angular-threshold", "horn-no-hook",
     "anderson", "traced-budget"],
)
def test_generic_align_matches_jax(scene, name):
    matchers, kw, budget = _case(name)
    res, its = _align_both(scene, matchers, kw, budget)
    # what the case must exercise
    assert len(set(its)) > 1, f"iteration counts must differ across the fleet: {its}"
    if "hook_min_trans" in kw and budget is None:
        assert res.hook_stop.tolist() == [False, False, True]
        # (a matcher past its runUpToIteration pairs nothing in the quality pass)
        assert res.converged[:2].all() and float(res.quality[:2].min()) > (0.3 if name == "run-from-up-to" else 0.8)
    if budget is not None:
        assert res.iterations.tolist()[0] == 3 and res.iterations.tolist()[2] == 1
    if name == "horn-no-hook":
        assert not res.hook_stop.any() and float(res.quality.min()) > 0.8


def test_point_to_plane_names_its_roadmap_item(scene):
    """Point-to-plane matching against a point map (a plane fitted per
    query to its candidates, ``voxel_hash.p2pl_from``), beside a
    point-to-point matcher on the second map, runs the generic loop as the
    JAX package does; so does the lidar2d matcher, two pairings per point
    against an occupancy map (its coarse match index of occupied voxel
    centers), whose map both packages build equal word for word."""
    from mola_lidar_odometry_tpu.ops import occupancy as jocc
    from mola_lidar_odometry_tpu.ops.pointcloud import PointCloud as JPC
    from mola_lidar_odometry_tpu_torch.ops import maps as tmaps

    matchers = [dict(kind="point2plane", threshold="1.0*" + ANNEAL),
                dict(local_layer="icp_near", global_layer="localmap_far", threshold="1.5*" + ANNEAL, weight=0.7)]
    res, its = _align_both(scene, matchers, dict(nn_neighbors=27, max_iterations=30, **HOOK))
    assert float(res.quality[:2].min()) > 0.5 and len(set(its)) > 1

    pts = _world()
    d = tmaps.MapLayerDef(map_class="CVoxelMap", num_slots=1 << 14, ray_trace_free_space=False)
    tm, _ = tmaps.insert_stats(tmaps.set_voxel_size(d.create(1.0, B, "cpu"), 0.125),
                               TPC.from_xyz(torch.from_numpy(np.stack([pts] * B))), None, d)
    jm = jax.jit(lambda pc: jocc.insert(jocc.OccupancyMap.create(1 << 14, 0.125), pc, ray_trace=False))(
        JPC.from_xyz(jnp.asarray(pts)))
    for f in ("keys", "used", "logodds"):
        np.testing.assert_array_equal(getattr(tm, f)[2].numpy(), np.asarray(getattr(jm, f)), err_msg=f)
    np.testing.assert_array_equal(tm.match.data[2].numpy(), np.asarray(jm.match.data))
    occ = dict(scene, jmaps=dict(scene["jmaps"], localmap=jm), tmaps=dict(scene["tmaps"], localmap=tm))
    res, its = _align_both(occ, [dict(pairings_per_point=2)], dict(nn_neighbors=27, max_iterations=40, **HOOK))
    assert float(res.quality[:2].min()) > 0.5 and len(set(its)) > 1
