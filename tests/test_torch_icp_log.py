"""Port parity for the ICP debug logs (``utils/icp_log.py``, the module of
this slice that reaches a kernel): with ``MP2P_ICP_GENERATE_DEBUG_FILES=1``
and decimation 3 both packages' ``LidarOdometry`` step the same 4 simulated
frames at small capacities, logging frames 0 and 3.  The replay re-runs
each logged align on the pre-step carry for 30 iterations through the
generic matcher: on lidar3d-default it pairs through kernel B4
(``pallas_match.nn_select``, its plain twin on the CPU; the JAX package runs
its Pallas kernel in interpret mode, ``MOLA_TPU_PALLAS=1
MOLA_TPU_PER_VOXEL_NN=1 MOLA_TPU_PALLAS_CAPTURE=1``, as the odometry parity
test does).

Tolerances: ``paired``, ``iterations``, the ``valid`` column of the pair
details and the logged frames are exact; poses and the pair details'
coordinates within 1e-5 m and 1e-5 rad, the family gate; the distance
to the target within what such a pose difference moves it, 1e-5 m plus
1e-5 rad times the point's range; ``quality`` equal (the pre-step carry's,
equal after equal steps)."""

import os

import numpy as np
import pytest
import torch

from mola_lidar_odometry_tpu_torch.models.odometry import LidarOdometry as TLO
from mola_lidar_odometry_tpu_torch.utils import icp_log, sim

HERE = os.path.dirname(os.path.abspath(__file__))
DEFAULT = os.path.join(HERE, "..", "pipelines", "lidar3d-default.yaml")
CAPS = dict(
    raw_capacity=1 << 13, map_slots=1 << 14,
    layer_capacities={"raw": 1 << 13, "decimated_for_map_raw": 4096, "decimated_for_icp_skewed": 2048,
                      "decimated_for_icp": 2048, "decimated_for_map": 4096},
)
ENV = {"MOLA_TPU_PALLAS": "1", "MOLA_TPU_PER_VOXEL_NN": "1", "MOLA_TPU_PALLAS_CAPTURE": "1",
       "MP2P_ICP_GENERATE_DEBUG_FILES": "1", "MP2P_ICP_LOG_FILES_DECIMATION": "3"}
FRAMES = 4
LOGS = ("icp-run-000000.icplog.npz", "icp-run-000003.icplog.npz")
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port steps on one torch thread (the tests run beside others)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _step(lo, scans, traj, workdir):
    os.chdir(workdir)  # the logs go to ./icp-logs
    outs = []
    for k, (xyz, times, rings, valid) in enumerate(scans):
        outs.append(lo.on_lidar_scan(xyz[valid], traj.stamps[k], times=times[valid], ring=rings[valid]))
    return outs


@pytest.fixture(scope="module")
def logs(tmp_path_factory):
    """Both packages' logs of the same frames, and the port's B4 calls."""
    from mola_lidar_odometry_tpu.models.odometry import LidarOdometry as JLO
    from mola_lidar_odometry_tpu_torch.ops import pallas_match

    mp = pytest.MonkeyPatch()
    for k, v in ENV.items():
        mp.setenv(k, v)
    cwd = os.getcwd()
    calls = []
    select = pallas_match.nn_select
    mp.setattr(pallas_match, "nn_select", lambda planar, q: calls.append(tuple(q.shape)) or select(planar, q))
    try:
        traj, scans = sim.simulate_sequence(FRAMES, n_rings=16, n_azimuth=512)
        jdir, tdir = tmp_path_factory.mktemp("jax"), tmp_path_factory.mktemp("port")
        jouts = _step(JLO.from_yaml_file(DEFAULT, env={}, **CAPS), scans, traj, jdir)
        touts = _step(TLO.from_yaml_file(DEFAULT, env={}, device="cpu", **CAPS), scans, traj, tdir)
    finally:
        os.chdir(cwd)
        mp.undo()
    return dict(jdir=jdir, tdir=tdir, jouts=jouts, touts=touts, calls=calls)


def _load(d, name):
    return dict(np.load(d / "icp-logs" / name))


def test_logged_frames_follow_the_decimation(logs):
    assert sorted(os.listdir(logs["tdir"] / "icp-logs")) == sorted(os.listdir(logs["jdir"] / "icp-logs")) == list(LOGS)
    for jo, to in zip(logs["jouts"], logs["touts"]):
        assert bool(to.accepted) and bool(jo.accepted)
        np.testing.assert_allclose(to.pose_t, np.asarray(jo.pose_t), atol=TOL)


@pytest.mark.parametrize("name", LOGS)
def test_icp_logs_match_jax(logs, name):
    t, j = _load(logs["tdir"], name), _load(logs["jdir"], name)
    assert sorted(t) == sorted(j)
    for k in ("paired", "iterations", "detail_iters"):
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)
        assert t[k].dtype == j[k].dtype, k
    assert t["stamp"] == j["stamp"] and t["quality"] == j["quality"]
    for k in ("poses_t", "pose0_t"):
        np.testing.assert_allclose(t[k], j[k], atol=TOL, rtol=0, err_msg=k)
    for k in ("poses_R", "pose0_R"):  # rotation-matrix entries: radians to first order
        np.testing.assert_allclose(t[k], j[k], atol=TOL, rtol=0, err_msg=k)
    td, jd = t["pair_details"], j["pair_details"]
    assert td.shape == jd.shape == (10, CAPS["layer_capacities"]["decimated_for_icp"], 8)
    np.testing.assert_array_equal(td[..., 7], jd[..., 7])
    np.testing.assert_allclose(td[..., :6], jd[..., :6], atol=TOL, rtol=0)
    # the distance to the target at the iteration's pose: a pose within TOL m
    # and TOL rad moves it by at most TOL * (1 + range of the local point)
    lever = 1.0 + np.linalg.norm(td[..., :3], axis=-1)
    assert (np.abs(np.sqrt(td[..., 6]) - np.sqrt(jd[..., 6])) <= TOL * lever).all()


def test_frame0_replays_against_the_empty_map(logs):
    first, later = _load(logs["tdir"], LOGS[0]), _load(logs["tdir"], LOGS[1])
    assert not first["paired"].any() and not first["pair_details"][..., 7].any()
    assert (later["paired"] > 0).all() and later["pair_details"][..., 7].any()
    for log in (first, later):
        for k in ("poses_R", "poses_t", "pose0_R", "pose0_t", "pair_details"):
            assert np.isfinite(log[k]).all(), k
    assert float(first["quality"]) == 1.0  # the initial carry's


def test_replay_pairs_through_kernel_b4(logs):
    """The step runs the fused path (B1-B3); each logged frame's replay
    calls B4's wrapper once per iteration and matcher (30 x 1 here)."""
    n_icp = CAPS["layer_capacities"]["decimated_for_icp"]
    assert logs["calls"] == [(1, n_icp, 3)] * (30 * len(LOGS))


def test_iteration_details_switch(tmp_path, monkeypatch):
    """``MP2P_ICP_LOG_ITER_DETAILS`` sets the detail period; 0 writes no
    pair details (as the JAX package)."""
    monkeypatch.chdir(tmp_path)
    traj, scans = sim.simulate_sequence(2, n_rings=8, n_azimuth=256)
    for every, slots in (("0", None), ("7", 5)):
        monkeypatch.setenv("MP2P_ICP_LOG_ITER_DETAILS", every)
        w = icp_log.IcpLogWriter(directory=str(tmp_path / every), decimation=1)
        lo = TLO.from_yaml_file(DEFAULT, env={}, device="cpu", **CAPS)
        lo._icp_log = w
        for k in range(2):
            xyz, times, rings, valid = scans[k]
            lo.on_lidar_scan(xyz[valid], traj.stamps[k], times=times[valid], ring=rings[valid])
        log = np.load(tmp_path / every / "icp-run-000001.icplog.npz")
        if slots is None:
            assert "pair_details" not in log and "detail_iters" not in log
        else:
            assert log["pair_details"].shape[0] == slots and log["detail_iters"].tolist() == [0, 7, 14, 21, 28]
