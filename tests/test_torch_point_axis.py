"""The point axis (``parallel/point_axis.py``, ``parallel/batch.py::
PointShardedFleet``) on the CPU, against the port's one-process fleet and
against the JAX package's ``make_sharded_fleet_step``.

Every scan of the 16 x 256 simulated sequence goes through the sizes of
``tests/test_parallel.py``'s sequence test (raw capacity 4096, 8192 slots).
Ranks are spawned processes with one torch thread each, joined over
``gloo``.

  * The collectives on two ranks: rank-order gathers, offsets, max, sum and
    any, the compacting gather (with and without truncation), the
    timestamp and intensity reductions, every filter-graph op on a slice,
    the Gauss-Newton and Horn sums and the one-to-one claims, each against
    the one-device computation on the whole layer.
  * lidar3d-default at fleet 2 x point 2 for 3 steps: every output equals
    the one-process fleet's bit for bit (the fused path's kernels run on
    the whole ICP layer on every rank), the map tables' hashes too, on
    every cell;
    and every field is within the family tolerance of the JAX package's
    sharded step on a 2 x 2 sub-mesh of the 8 virtual CPU devices (the
    Pallas kernels in interpret mode: tests/test_torch_step.py's switches
    and bounds).
  * lidar3d-dual-map (the generic loop) at fleet 1 x point 2 for 4 steps:
    integers equal the one-process fleet's, poses within 1e-5 (the summed
    normal equations are added in another order; the loop stops on steps
    below 1e-4 m and 5e-5 rad, so a reordering moves the answer by a small
    part of the last step, a tenth of which is the bound), and every field
    within tests/test_torch_step_dualmap.py's bounds of the JAX sharded
    step on a 1 x 2 sub-mesh.
  * Refusals: a point axis that does not divide N, a device count that
    does not divide into rows.
  * A rank that fails, or one that is killed, ends the fleet with an error.

Every test that spawns runs under its own time limit (``_limit``), so a
hang fails that test instead of running the suite into its cap.
"""

import contextlib
import os
import signal

import jax
import numpy as np
import pytest
import torch

from mola_lidar_odometry_tpu_torch.models.spec import spec_from_yaml as t_spec_from_yaml
from mola_lidar_odometry_tpu_torch.parallel import batch as tpb
from mola_lidar_odometry_tpu_torch.parallel import point_axis as pa
from mola_lidar_odometry_tpu_torch.utils import sim
from mola_lidar_odometry_tpu_torch.utils.config import load_yaml_file as t_load

HERE = os.path.dirname(os.path.abspath(__file__))
DEFAULT = os.path.join(HERE, "..", "pipelines", "lidar3d-default.yaml")
DUALMAP = os.path.join(HERE, "..", "pipelines", "extras", "lidar3d-dual-map.yaml")
CAPS = {
    "raw": 4096, "decimated_for_map_raw": 2048, "decimated_for_map_by_range": 2048,
    "decimated_for_map_skewed": 2048, "decimated_for_map": 2048, "decimated_for_icp_skewed": 1024,
    "decimated_for_icp": 1024, "decimated_for_icp_near_skewed": 1024, "decimated_for_icp_near": 1024,
}
SIZING = dict(raw_capacity=4096, map_slots=1 << 13, layer_capacities=CAPS, kf_ring_capacity=64)
INTEGERS = ("iterations", "processed", "accepted", "kf_local", "kf_simplemap", "sm_insert", "map_restarted",
            "n_raw", "n_icp_layer", "n_map_layer", "corrections", "map_collision_drops", "map_full_drops",
            "deferred_drops")
GENERIC_POSE_TOL = 1e-5
ANSWER_S = 120.0


@contextlib.contextmanager
def _limit(seconds: int):
    """Raise TimeoutError in this (the main) thread after ``seconds``."""

    def expired(signum, frame):
        raise TimeoutError(f"over the test's limit of {seconds} s")

    old = signal.signal(signal.SIGALRM, expired)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


def _spec(path):
    return t_spec_from_yaml(t_load(path, env={}), **SIZING)


def _sequence(n):
    return sim.simulate_sequence(n, n_rings=16, n_azimuth=256, speed=2.0, noise=0.01, max_range=40.0)


def _one_process(spec, batch, traj, scans):
    """The port's one-process fleet over the scans (one torch thread):
    (outputs as numpy per step, the last carry)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        fstep = tpb.make_fleet_step(spec)
        carry = tpb.init_fleet_carry(spec, batch, device="cpu")
        outs = []
        for k, s in enumerate(scans):
            carry, out = fstep(carry, tpb.pack_scans(spec, [s] * batch, [traj.stamps[k]] * batch, device="cpu"))
            outs.append({f: v.numpy() for f, v in zip(out._fields, out)})
        return outs, carry
    finally:
        torch.set_num_threads(threads)


def _sharded(spec, mesh, traj, scans):
    """The PointShardedFleet over the scans: (outputs, map hashes (F, P)
    and collectives of cell 0, each per step)."""
    outs, hashes, colls = [], [], []
    with tpb.PointShardedFleet(spec, mesh, threads=1, answer_s=ANSWER_S) as fleet:
        for k, s in enumerate(scans):
            out = fleet.step([s] * fleet.batch, [traj.stamps[k]] * fleet.batch)
            outs.append(out._asdict())
            hashes.append(fleet.map_hashes)
            colls.append(fleet.collectives[0])
    return outs, hashes, colls


def _jax_sharded(path, F, P, env, traj, scans):
    """The JAX package's make_sharded_fleet_step on the first F * P virtual
    CPU devices, ``env`` set while its spec is built and traced."""
    mp = pytest.MonkeyPatch()
    for k, v in env.items():
        mp.setenv(k, v)
    try:
        from mola_lidar_odometry_tpu.models.spec import spec_from_yaml
        from mola_lidar_odometry_tpu.parallel import batch as jpb
        from mola_lidar_odometry_tpu.utils.config import load_yaml_file

        if len(jax.devices()) < F * P:
            pytest.fail(f"needs {F * P} virtual CPU devices (tests/conftest.py sets 8)")
        jspec = spec_from_yaml(load_yaml_file(path, env={}), **SIZING)
        jitted, carry, s_sh = jpb.make_sharded_fleet_step(jspec, jpb.make_mesh(F * P, point_axis=P))
        outs = []
        for k, s in enumerate(scans):
            scan = jax.device_put(jpb.pack_scans(jspec, [s] * F, [float(traj.stamps[k])] * F), s_sh)
            carry, out = jitted(carry, scan)
            outs.append({f: np.asarray(v) for f, v in out._asdict().items()})
        return outs
    finally:
        mp.undo()


def _family_bounds(got, want, where):
    """tests/test_torch_step.py's bounds: counts and flags exact, poses
    within 5e-3, iterations within one, quality within 0.02."""
    for f in ("n_raw", "n_icp_layer", "n_map_layer", "accepted", "kf_local"):
        np.testing.assert_array_equal(got[f], want[f], err_msg=f"{f} {where}")
    np.testing.assert_allclose(got["pose_t"], want["pose_t"], atol=5e-3, err_msg=where)
    np.testing.assert_allclose(got["pose_R"], want["pose_R"], atol=5e-3, err_msg=where)
    assert np.all(np.abs(got["iterations"].astype(int) - want["iterations"]) <= 1), where
    np.testing.assert_allclose(got["quality"], want["quality"], atol=0.02, err_msg=where)


# ---------------------------------------------------------------------------
# the collectives on two ranks
# ---------------------------------------------------------------------------

def _helper_rank(rank, address, conn):
    """Rank ``rank`` of 2: every helper against the one-device computation
    on the whole data (both ranks make it from one seed); sends the list of
    failures."""
    import torch.distributed as dist

    from mola_lidar_odometry_tpu_torch.models import filter_graph as FG
    from mola_lidar_odometry_tpu_torch.ops import filters as F, se3
    from mola_lidar_odometry_tpu_torch.ops.icp import _one_to_one
    from mola_lidar_odometry_tpu_torch.ops.pointcloud import PointCloud
    from mola_lidar_odometry_tpu_torch.ops.solver import PairingBlock, PosePrior, gauss_newton_step_blocks, solve_horn
    from mola_lidar_odometry_tpu_torch.utils.expr import Expr

    torch.set_num_threads(1)
    fails = []
    try:
        dist.init_process_group("gloo", init_method=address, world_size=2, rank=rank,
                                timeout=__import__("datetime").timedelta(seconds=60))
        axis = pa.PointAxis(dist.new_group([0, 1]), rank, 2)

        def check(name, ok):
            if not ok:
                fails.append(name)

        g = pa.gather_points(torch.full((2, 3), float(rank)), axis)
        check("gather order", torch.equal(g, torch.tensor([[0.0] * 3 + [1.0] * 3] * 2)))
        offs, counts = pa.scatter_offsets(torch.tensor([3, 0]) if rank == 0 else torch.tensor([5, 2]), axis)
        check("offsets", torch.equal(offs, torch.tensor([[0, 3], [0, 0]])) and
              torch.equal(counts, torch.tensor([[3, 5], [0, 2]])))
        check("max", torch.equal(pa.all_max(torch.tensor([rank, -rank]), axis), torch.tensor([1, 0])))
        check("sum", torch.equal(pa.all_sum(torch.tensor([1.5, rank]), axis), torch.tensor([3.0, 1.0])))
        check("any", torch.equal(pa.all_any(torch.tensor([rank == 1, False]), axis), torch.tensor([True, False])))

        rng = np.random.default_rng(7)
        n = 64
        whole = PointCloud(
            xyz=torch.from_numpy(rng.normal(size=(2, n, 3)).astype(np.float32)),
            time=torch.from_numpy(rng.uniform(-0.05, 0.05, (2, n)).astype(np.float32)),
            intensity=torch.from_numpy(rng.uniform(0, 90, (2, n)).astype(np.float32)),
            ring=(torch.arange(n, dtype=torch.int32) // 24).expand(2, n),  # a ring spans the ranks' boundary
            valid=torch.from_numpy(rng.uniform(size=(2, n)) < np.array([[0.95], [0.2]])),
        )
        mine = pa.PointSlice(*(pa.own_rows(t, axis) for t in whole))
        check("own rows", torch.equal(mine.xyz, whole.xyz[:, rank * 32:(rank + 1) * 32]))
        for f, a, b in zip(PointCloud._fields, pa.gather_cloud(mine, axis), whole):
            check(f"gather_cloud {f}", torch.equal(a, b))
        for cap in (80, 20):  # more room than points; fewer (instance 0's truncated)
            for f, a, b in zip(PointCloud._fields, pa.gather_compact(mine, cap, axis), whole.compact(cap)):
                check(f"gather_compact {cap} {f}", torch.equal(a, b))
        adj = pa.gather_cloud(F.adjust_timestamps(mine, offset=0.01, axis=axis), axis)
        check("adjust_timestamps", torch.equal(adj.time, F.adjust_timestamps(whole, offset=0.01).time))
        nrm = pa.gather_cloud(F.normalize_intensity(mine, axis=axis), axis)
        check("normalize_intensity", torch.equal(nrm.intensity, F.normalize_intensity(whole).intensity))

        pose = se3.Pose(se3.so3_exp(torch.tensor([[0.01, -0.02, 0.03]] * 2)), torch.tensor([[0.1, 0.0, -0.1]] * 2))
        q = whole.xyz + 0.05
        blk = PairingBlock("p2p", whole.xyz, q, torch.zeros_like(q), whole.valid, 1.0)
        blk_mine = PairingBlock("p2p", mine.xyz, pa.own_rows(q, axis), torch.zeros_like(mine.xyz), mine.valid, 1.0)
        prior = PosePrior.none(2, "cpu")
        want, _ = gauss_newton_step_blocks(pose, [blk], 0.5, prior)
        got, _ = gauss_newton_step_blocks(pose, [blk_mine], 0.5, prior, axis=axis)
        check("gauss-newton sums", torch.allclose(got.t, want.t, atol=1e-6) and torch.allclose(got.R, want.R, atol=1e-6))
        hw = solve_horn(whole.xyz, q, whole.valid)
        hg = solve_horn(mine.xyz, pa.own_rows(q, axis), mine.valid, axis=axis)
        check("horn sums", torch.allclose(hg.t, hw.t, atol=1e-5) and torch.allclose(hg.R, hw.R, atol=1e-5))
        # every filter-graph op on the slice against the op on the whole layer
        env = {k: torch.full((2,), 0.1) for k in ("vx", "vy", "vz", "wx", "wy", "wz")}
        E = Expr
        for op in (FG.AdjustTimestampsOp("raw", time_offset=E(0.01)), FG.NormalizeIntensityOp("raw"),
                   FG.DecimateOp("raw", "out", E(0.5), 40), FG.DecimateOp("raw", "out", E(0.5), 40, "ClosestToAverage"),
                   FG.DecimateOp("raw", "out", E(0.5), 40, min_input_points=30),
                   FG.CurvatureOp("raw", out_larger="out", out_smaller="out2", max_cosine=0.9),
                   FG.EdgesFromRangeImageOp(target_layer="out", planes_target_layer="out2", score_threshold=50.0),
                   FG.RangeOp("raw", "out", "out2", E(0.5), E(1.5)),
                   FG.BBoxOp("raw", "out", "out2", (E(-1),) * 3, (E(1),) * 3), FG.DeskewOp("raw", "out"),
                   FG.ByIntensityOp("raw", E(20.0), E(60.0), out_low="out", out_high="out2")):
            want = FG.apply_pipeline([op], {"raw": whole}, env)
            got = FG.apply_pipeline([op], {"raw": mine}, env, axis)
            for name in want:
                for f, a, b in zip(PointCloud._fields, pa.gather_cloud(got[name], axis), want[name]):
                    check(f"{type(op).__name__} {name} {f}", torch.equal(a, b))
        tgt = torch.round(whole.xyz * 2) / 2  # many queries claim one target
        keep = _one_to_one(pa.own_rows(tgt, axis), None, mine.valid, axis)
        check("one-to-one claims", torch.equal(keep, pa.own_rows(_one_to_one(tgt, None, whole.valid), axis)))
        counts = axis.take_counts()
        check(f"counted {counts}", counts["all_gather"][0] > 0 and counts["all_reduce"][0] > 0 and not axis.counts)
    except Exception as e:  # reported to the test
        fails.append(repr(e))
    finally:
        conn.send(fails)
        conn.close()
        if dist.is_initialized():
            dist.destroy_process_group()


def test_collectives_on_two_ranks():
    ctx = torch.multiprocessing.get_context("spawn")
    address = tpb._free_address()
    with _limit(120):
        pipes, procs = [], []
        for r in range(2):
            parent, child = ctx.Pipe()
            procs.append(ctx.Process(target=_helper_rank, args=(r, address, child), daemon=True))
            procs[-1].start()
            child.close()
            pipes.append(parent)
        try:
            results = [p.recv() for p in pipes]
        finally:
            for p in procs:
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
    assert results == [[], []], results
    assert not any(p.is_alive() for p in procs)


# ---------------------------------------------------------------------------
# lidar3d-default at fleet 2 x point 2 (the fused path)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def default_runs():
    with _limit(300):
        traj, scans = _sequence(3)
        spec = _spec(DEFAULT)
        ref, carry = _one_process(spec, 2, traj, scans)
        got, hashes, colls = _sharded(spec, [["cpu", "cpu"], ["cpu", "cpu"]], traj, scans)
        return dict(traj=traj, scans=scans, ref=ref, carry=carry, got=got, hashes=hashes, colls=colls)


def test_default_2x2_equals_one_process_fleet(default_runs):
    for k, (g, r) in enumerate(zip(default_runs["got"], default_runs["ref"])):
        for f in r:
            np.testing.assert_array_equal(g[f], r[f], err_msg=f"{f} at step {k}")
    assert all(o["accepted"].all() for o in default_runs["got"])
    assert default_runs["got"][-1]["iterations"].min() > 0
    colls = default_runs["colls"][-1]  # the raw radius, counts, timestamps; the compacting gather, the map hashes
    print(f"lidar3d-default, fleet 2 x point 2, cell 0, collectives of the last step (calls, bytes): {colls}")
    assert colls["all_reduce"][0] >= 3 and colls["all_gather"][0] >= 3


def test_default_map_replicas_equal(default_runs):
    """Every cell's map words hash as the one-process fleet's instance of
    its row after the last step, and a row's cells agree after every step."""
    for k, rows in enumerate(default_runs["hashes"]):
        assert all(len(set(row)) == 1 for row in rows), f"step {k}: {rows}"
    want = pa.map_hash(default_runs["carry"].maps).tolist()
    assert default_runs["hashes"][-1] == [[h, h] for h in want]
    assert len({h for rows in default_runs["hashes"] for row in rows for h in row}) > 1  # the maps changed


def test_default_2x2_within_jax_sharded_step(default_runs):
    env = {"MOLA_TPU_PALLAS": "1", "MOLA_TPU_PER_VOXEL_NN": "1", "MOLA_TPU_PALLAS_CAPTURE": "1"}
    want = _jax_sharded(DEFAULT, 2, 2, env, default_runs["traj"], default_runs["scans"])
    for k, (g, w) in enumerate(zip(default_runs["got"], want)):
        _family_bounds(g, w, f"at step {k}")


# ---------------------------------------------------------------------------
# lidar3d-dual-map at fleet 1 x point 2 (the generic loop)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dualmap_runs():
    with _limit(300):
        traj, scans = _sequence(4)
        spec = _spec(DUALMAP)
        ref, _ = _one_process(spec, 1, traj, scans)
        got, hashes, colls = _sharded(spec, [["cpu", "cpu"]], traj, scans)
        return dict(traj=traj, scans=scans, ref=ref, got=got, hashes=hashes, colls=colls)


def test_dualmap_1x2_equals_one_process_fleet(dualmap_runs):
    worst = 0.0
    for k, (g, r) in enumerate(zip(dualmap_runs["got"], dualmap_runs["ref"])):
        for f in INTEGERS:
            np.testing.assert_array_equal(g[f], r[f], err_msg=f"{f} at step {k}")
        for f in ("pose_R", "pose_t"):
            np.testing.assert_allclose(g[f], r[f], rtol=0, atol=GENERIC_POSE_TOL, err_msg=f"{f} at step {k}")
            worst = max(worst, float(np.abs(g[f].astype(np.float64) - r[f]).max()))
        np.testing.assert_allclose(g["quality"], r["quality"], rtol=0, atol=1e-6)
    assert all(len(set(row)) == 1 for rows in dualmap_runs["hashes"] for row in rows)
    assert dualmap_runs["got"][-1]["iterations"].min() > 0
    print(f"lidar3d-dual-map, fleet 1 x point 2: largest pose difference from the one-process fleet {worst:.3g}; "
          f"collectives of the last step {dualmap_runs['colls'][-1]}")


def test_dualmap_1x2_within_jax_sharded_step(dualmap_runs):
    env = {"MOLA_TPU_PER_VOXEL_NN": "1", "MOLA_TPU_PALLAS": "0"}
    want = _jax_sharded(DUALMAP, 1, 2, env, dualmap_runs["traj"], dualmap_runs["scans"])
    for k, (g, w) in enumerate(zip(dualmap_runs["got"], want)):
        _family_bounds(g, w, f"at step {k}")


# ---------------------------------------------------------------------------
# refusals and failures
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["points", "devices"])
def test_refusals(case):
    if case == "devices":
        with pytest.raises(ValueError, match="do not divide"):
            tpb.make_mesh(3, point_axis=2, device="cpu")
        assert tpb.make_mesh(4, point_axis=2, device="cpu") == [["cpu", "cpu"], ["cpu", "cpu"]]
        return
    spec = t_spec_from_yaml(t_load(DEFAULT, env={}), **dict(SIZING, raw_capacity=4095))
    with pytest.raises(ValueError, match="do not divide over a point axis of 2"):
        tpb.PointShardedFleet(spec, [["cpu", "cpu"]])
    carry = tpb.init_fleet_carry(spec, 1, device="cpu")
    scan = tpb.pack_scans(spec, [(np.zeros((1, 3), np.float32),) + (np.zeros(1, np.float32),
                                  np.zeros(1, np.int32), np.ones(1, bool))], [0.0], device="cpu")
    with pytest.raises(ValueError, match="do not divide over a point axis of 2"):
        tpb.fleet_shardings([["cpu", "cpu"]], carry, scan)
    c_specs, s_specs = tpb.fleet_shardings([["cpu"]], carry, scan)
    assert s_specs.xyz == ("fleet", "point", None) and s_specs.stamp == ("fleet",)
    assert c_specs.pose_R == ("fleet", None, None)


@pytest.mark.parametrize("how", ["fails", "killed"])
def test_a_failed_rank_ends_the_fleet(how):
    traj, scans = _sequence(1)
    with _limit(120):
        fleet = tpb.PointShardedFleet(_spec(DEFAULT), [["cpu", "cpu"]], threads=1, answer_s=60)
        procs = list(fleet._procs)
        try:
            if how == "fails":
                # rank 1 is asked for what it cannot do while rank 0 steps and
                # waits in a collective for it
                fleet._conns[0].send(("step", fleet._parts([scans[0]], [traj.stamps[0]])[0]))
                fleet._conns[1].send(("nothing",))
                with pytest.raises(RuntimeError, match=r"mesh cell \(0, 1\) .* failed"):
                    fleet._gather()
            else:
                procs[1].kill()
                procs[1].join(timeout=30)
                with pytest.raises(RuntimeError, match=r"mesh cell \(0, 1\) .* ended"):
                    fleet.step([scans[0]], [traj.stamps[0]])
            for p in procs:
                p.join(timeout=30)
            assert not any(p.is_alive() for p in procs)
            with pytest.raises(RuntimeError, match="fleet is closed"):
                fleet.step([scans[0]], [traj.stamps[0]])
        finally:
            fleet.close()

