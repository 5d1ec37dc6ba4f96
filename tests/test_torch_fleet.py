"""The fleet over several devices (``parallel/batch.py::ShardedFleet``) and
its user entry point (``apps/fleet_eval.py``), on the CPU.

  * Two spawned shard workers (two CPU "devices", one torch thread each)
    step a B = 4 fleet of lidar3d-default for 2 steps; their outputs,
    gathered in instance order, equal the one-process fleet's bit for bit.
  * A shard that fails ends the fleet: the other shards' answers are never
    read as a later step's, because every later step raises.
  * ``parallel/fleet_probe.py`` on two CPU "devices": the in-process,
    split-process and one-thread-per-device fleets all equal the one-device
    fleet bit for bit.
  * A fleet that does not divide over its devices is refused, as the JAX
    package's ``make_shardmap_fleet_step`` refuses it.
  * ``fleet_eval`` at ``--batch 2 --frames 3 --rings 16``: its worlds and
    trajectories are the JAX script's (``eval/fleet_eval.py``: world seed b,
    trajectory seed 100 + b, through the JAX package's ``utils/sim.py``),
    and its report carries the JAX script's keys.
"""

import ast
import json
import os

import numpy as np
import pytest
import torch

from mola_lidar_odometry_tpu_torch.models.spec import spec_from_yaml
from mola_lidar_odometry_tpu_torch.parallel import batch as pb
from mola_lidar_odometry_tpu_torch.utils import sim
from mola_lidar_odometry_tpu_torch.utils.config import load_yaml_file

HERE = os.path.dirname(os.path.abspath(__file__))
PIPELINE = os.path.join(HERE, "..", "pipelines", "lidar3d-default.yaml")
B = 4


def _spec():
    caps = {n: 1024 for n in ("raw", "decimated_for_map_raw", "decimated_for_icp_skewed", "decimated_for_icp",
                              "decimated_for_map", "decimated_for_map_skewed", "decimated_for_map_by_range")}
    return spec_from_yaml(load_yaml_file(PIPELINE, env={}), raw_capacity=1024, map_slots=1 << 12,
                          layer_capacities=caps)


def test_split_fleet_equals_one_process_fleet():
    spec = _spec()
    scans_by_instance = []
    stamps_by_instance = []
    for b in range(B):  # each instance its own trajectory
        traj, scans = sim.simulate_sequence(2, n_rings=4, n_azimuth=180, speed=1.0 + 0.5 * b, traj_seed=b)
        scans_by_instance.append(scans)
        stamps_by_instance.append(traj.stamps)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        fstep = pb.make_fleet_step(spec)
        carry = pb.init_fleet_carry(spec, B, device="cpu")
        ref = []
        for k in range(2):
            carry, out = fstep(carry, pb.pack_scans(spec, [s[k] for s in scans_by_instance],
                                                    [t[k] for t in stamps_by_instance], device="cpu"))
            ref.append(out)
    finally:
        torch.set_num_threads(threads)
    with pb.ShardedFleet(spec, B, ["cpu", "cpu"], threads=1) as fleet:
        assert fleet.per_shard == 2
        for k in range(2):
            got = fleet.step([s[k] for s in scans_by_instance], [t[k] for t in stamps_by_instance])
            for name, g, r in zip(got._fields, got, ref[k]):
                np.testing.assert_array_equal(g, r.numpy(), err_msg=f"{name} step {k}")
        assert bool(np.all(got.processed)) and bool(np.all(got.accepted))


def test_a_failed_shard_ends_the_fleet():
    traj, scans = sim.simulate_sequence(1, n_rings=4, n_azimuth=180)
    good = scans[0]
    bad = (good[0][:, :2],) + tuple(good[1:])  # xyz of the wrong width: shard 0 fails to pack it
    fleet = pb.ShardedFleet(_spec(), B, ["cpu", "cpu"], threads=1)
    procs = list(fleet._procs)
    with pytest.raises(RuntimeError, match="fleet shard 0 .* failed"):
        fleet.step([bad] + [good] * (B - 1), [traj.stamps[0]] * B)
    assert not any(p.is_alive() for p in procs)
    with pytest.raises(RuntimeError, match="fleet is closed"):
        fleet.step([good] * B, [traj.stamps[0]] * B)
    fleet.close()


def test_fleet_probe_modes_agree(capsys):
    from mola_lidar_odometry_tpu_torch.parallel import fleet_probe

    threads = torch.get_num_threads()
    try:
        rc = fleet_probe.main(["--device", "cpu", "--devices", "2", "--per-device", "2", "--frames", "3",
                               "--rings", "8", "--azimuth", "256"])
    finally:
        torch.set_num_threads(threads)
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and sorted(report["modes"]) == ["alone", "one card", "processes", "threads"]
    assert all(m["equal"] and m["s_per_step"] > 0 for m in report["modes"].values())
    assert report["modes"]["one card"]["instances"] == 4 and report["modes"]["alone"]["instances"] == 2


def test_fleet_must_divide_over_its_devices():
    with pytest.raises(ValueError, match="must divide"):
        pb.ShardedFleet(_spec(), 3, ["cpu", "cpu"])
    assert pb.fleet_devices(3, "cpu") == ["cpu"] * 3


def test_fleet_eval_matches_the_jax_script(capsys):
    from mola_lidar_odometry_tpu.utils import sim as jsim
    from mola_lidar_odometry_tpu_torch.apps import fleet_eval

    trajs, stacks = fleet_eval.simulate_fleet(2, 3, 16, 1024)
    for b in range(2):
        jtraj, jscans = jsim.simulate_sequence(3, world_seed=b, traj_seed=100 + b, n_rings=16, n_azimuth=1024)
        for f in ("R", "t", "stamps", "twists"):
            np.testing.assert_array_equal(getattr(trajs[b], f), getattr(jtraj, f))
        for got, want in zip(stacks[b], jscans):
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        assert fleet_eval.main(["--batch", "2", "--frames", "3", "--rings", "16", "--device", "cpu"]) == 0
    finally:
        torch.set_num_threads(threads)
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    with open(os.path.join(HERE, "..", "eval", "fleet_eval.py")) as f:
        tree = ast.parse(f.read())
    jax_keys = next(
        [k.value for k in node.value.keys] for node in ast.walk(tree)
        if isinstance(node, ast.Assign) and getattr(node.targets[0], "id", "") == "result"
    )
    assert set(jax_keys) <= set(report) and report["device"] == "cpu" and report["batch"] == 2
    assert len(report["ate_rmse_per_instance_m"]) == 2 and report["mean_quality"] > 0.5
    assert max(report["ate_rmse_per_instance_m"]) < 0.5
