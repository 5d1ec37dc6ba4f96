"""``correct`` on the CPU at a size a test run holds: a sound run of the
port passes the cell's limits; the control and each fault the cells can
have fail them."""

import functools
import json
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from port_bench import readings, run  # noqa: E402
from port_bench.harness import check, program  # noqa: E402

CELL = "lidar3d-default.fleet64-drive"
SMALL = dict(instances=4, rings=16, azimuths=512)


def small_cell():
    cell = program.load_cell(CELL)
    tr = cell.traffic
    cell.traffic = dict(tr, instances=SMALL["instances"],
                        sensor=dict(tr["sensor"], rings=SMALL["rings"], azimuths=SMALL["azimuths"]))
    cell.settings = dict(cell.settings, warmup_steps=2)
    return cell


def unchanged(step):
    """A step that returns its state unchanged."""
    def f(c, s):
        return c, step(c, s)[1]
    return f


def half_left_out(step):
    """Half of the fleet left out: those instances keep their state and
    answer with their last pose."""
    from mola_lidar_odometry_tpu_torch.models.step import select

    def f(c, s):
        c2, out = step(c, s)
        keep = torch.arange(c.pose_t.shape[0]) < c.pose_t.shape[0] // 2
        return select(keep, c2, c), select(keep, out, out._replace(pose_R=c.pose_R, pose_t=c.pose_t))
    return f


def altered(step):
    """Every instance's pose at frame 20 moved 20 m where it is produced."""
    def f(c, s):
        c2, out = step(c, s)
        if abs(float(s.stamp[0]) - 2.0) < 1e-3:
            out = out._replace(pose_t=out.pose_t + torch.tensor([20.0, 0.0, 0.0]))
        return c2, out
    return f


@pytest.mark.parametrize("fault", [None, unchanged, half_left_out, altered],
                         ids=["sound", "state_unchanged", "half_left_out", "answer_altered"])
def test_correct_holds_a_sound_run_and_catches_each_fault(monkeypatch, fault):
    torch.set_num_threads(2)
    monkeypatch.setattr(program, "run_window", functools.partial(program.run_window, min_episodes=1))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    result, lines = run.run_cell(bench, small_cell(), 3000000077, 0.0, False, "cpu", time.perf_counter(),
                                 wrap_step=fault)
    assert [name for name, _, _ in lines] == list(small_cell().settings["limits"])
    assert result["correct"] is (fault is None), lines


def test_the_control_fails_the_limits():
    """The reference with no ICP iterations in the program's place, judged
    against the reference, over two instances of a whole small episode."""
    cell = small_cell()
    small = dict(cell.traffic, instances=2)
    wd, trajs, drives = program.gen_world.fleet(3000000078, small)
    frames, _ = program.raycast.fleet_scans(wd, trajs, small["sensor"], program.gen_world.noise_seeds(3000000078, small, drives),
                                            "cpu")
    seqs = {i: [(f[0][i][f[3][i]].double().numpy(), f[1][i][f[3][i]].double().numpy()) for f in frames]
            for i in range(2)}
    stamps = [float(np.float32(k / 10.0)) for k in range(len(frames))]
    yaml_path = str(program.BENCH / cell.config["pipeline"])
    ref = check.run_reference(yaml_path, seqs, stamps)
    ctl = check.run_reference(yaml_path, seqs, stamps, registration=False)
    found = check.numbers(readings.control_rows([ctl[0], ctl[1]]), ref, trajs)
    ok, lines = check.judge(found, cell.settings["limits"])
    assert not ok, lines
    sound, _ = check.judge(check.numbers(readings.control_rows([ref[0], ref[1]]), ref, trajs),
                           cell.settings["limits"])
    assert sound
