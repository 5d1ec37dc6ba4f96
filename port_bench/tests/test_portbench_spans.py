"""The readers of the fleet step's spans and counters (``harness/spans.py``)
on the CPU: the idle split on synthetic spans and device events, the host
split, the counters, ``None`` without spans, and the ten readers over a
small traced stretch of the port found from the run's frame."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from port_bench import run  # noqa: E402
from port_bench.harness import program, readings, spans  # noqa: E402
from port_bench.harness.program import FIELDS, Window  # noqa: E402

NEW = ("step.self_host_ms", "filters.host_ms", "icp.host_ms", "map.host_ms", "step.self_idle_ms", "filters.idle_ms",
       "icp.idle_ms", "map.idle_ms", "step.host_syncs", "icp.b3_waves")


def synthetic(device, on_trace, steps=1, host=(), counters=None):
    return spans.Spans(steps, list(host), counters or {}, 1.0, list(on_trace), list(device))


def test_a_gap_splits_across_two_spans():
    """One gap, 100-200 us: 100-140 in ``step.filters``, 140-170 in the
    step's own work, 170-200 in ``step.icp``."""
    dev = [(0.0, 100.0, "a"), (200.0, 300.0, "b")]
    on = [("step", 0, 50.0, 350.0), ("step.filters", 0, 60.0, 140.0), ("step.icp", 0, 170.0, 320.0)]
    idle = spans.idle_ms(synthetic(dev, on))
    assert idle == pytest.approx(dict(filters=0.040, icp=0.030, map=0.0, step=0.030, outside=0.0))


def test_a_gap_outside_every_span_goes_to_no_layer():
    dev = [(0.0, 100.0, "a"), (150.0, 200.0, "b"), (260.0, 300.0, "c")]
    on = [("step", 0, 0.0, 120.0), ("step.map", 0, 105.0, 115.0), ("step", 1, 250.0, 300.0)]
    idle = spans.idle_ms(synthetic(dev, on, steps=2))
    assert idle["map"] == pytest.approx(0.010 / 2)
    assert idle["step"] == pytest.approx((0.010 + 0.010) / 2)
    assert idle["outside"] == pytest.approx((0.030 + 0.050) / 2)
    assert idle["filters"] == idle["icp"] == 0.0


def test_the_idle_split_sums_to_the_stretch_idle():
    rng = np.random.default_rng(7)
    t, dev = 0.0, []
    for _ in range(400):
        t += rng.uniform(0, 30)
        dev.append((t, t + rng.uniform(1, 20), "k"))
        t = dev[-1][1] - rng.uniform(0, 5)  # some overlap
    on, t = [], 0.0
    for k in range(4):
        s0 = t + rng.uniform(0, 100)
        cut = np.sort(rng.uniform(s0, s0 + 1500, 6))
        on += [("step", k, s0, s0 + 1600), ("step.filters", k, cut[0], cut[1]), ("step.icp", k, cut[2], cut[3]),
               ("step.map", k, cut[4], cut[5])]
        t = s0 + 1700
    s = synthetic(dev, on, steps=4)
    idle = spans.idle_ms(s)
    total = readings.T.gap_analysis(dev)["idle"] * 1e-3 / 4
    assert sum(idle.values()) == pytest.approx(total, rel=1e-9)
    assert all(v >= -1e-12 for v in idle.values())


def test_host_split_and_counters():
    ms = 1_000_000
    host = [("step.filters", 0, 1 * ms, 3 * ms), ("step.icp", 0, 3 * ms, 7 * ms),
            ("step.map", 0, 7 * ms, 8 * ms), ("step", 0, 0, 10 * ms), ("step", 1, 20 * ms, 26 * ms)]
    s = synthetic([], [], steps=2, host=host, counters={"host_syncs": [1, 1, 1], "b3.waves": [4, 4, 5]})
    h = spans.host_ms(s)
    assert h == pytest.approx(dict(step=(3 + 6) / 2, filters=1.0, icp=2.0, map=0.5))
    assert sum(h.values()) == pytest.approx(16 / 2)  # the mean step span
    assert spans.counter_per_step(s, "host_syncs") == 1.5
    assert spans.counter_mean(s, "b3.waves") == pytest.approx(13 / 3)
    assert spans.counter_mean(s, "nothing") is None and spans.idle_ms(s) is None


def empty_readings(traced=True):
    r = readings.Readings(Window(seconds=1.0, steps=1), np.zeros((1, 1, sum(w for _, w in FIELDS)), np.float32))
    if traced:
        r.timeline = readings.Timeline([], 1, 1.0, 0.0, 0.0, 1.0)
    return r


@pytest.mark.parametrize("traced", [False, True], ids=["untraced", "traced_no_run"])
def test_every_new_reader_reads_nothing_without_spans(traced, capsys):
    r = empty_readings(traced)
    assert all(run.reader(name)(r) is None for name in NEW)
    assert r.spans is None
    said = capsys.readouterr().err
    assert said.count("no `prog` and `cell`") == int(traced), said  # once, on the first read


def test_the_readers_over_a_small_stretch_found_from_the_run():
    """A small fleet on the CPU, traced stretch of 2 steps from frame 2:
    every reader reads a number, the host split adds up to the mean
    ``step`` span, the idle split to the trace's idle."""
    torch.set_num_threads(2)
    cell = program.load_cell("lidar3d-default.fleet64-drive")
    tr = cell.traffic
    cell.traffic = dict(tr, instances=2, frames=4, sensor=dict(tr["sensor"], rings=16, azimuths=512))
    cell.settings = dict(cell.settings, trace=dict(start_frame=2, steps=2))
    prog = program.build(cell, 3000000079, "cpu", log=lambda *a: None)
    r = empty_readings()

    def run_cell_like(prog, cell):
        return {name: run.reader(name)(r) for name in NEW}

    read = run_cell_like(prog, cell)
    assert all(read[n] is not None for n in NEW if n != "icp.b3_waves"), read
    assert read["icp.b3_waves"] is None  # B3 runs on the card alone
    s = r.spans
    step_ms = [(t1 - t0) * 1e-6 for n, _, t0, t1 in s.host if n == "step"]
    assert len(step_ms) == 2
    assert 0.0 < sum(step_ms) * 1e-3 <= s.wall_s  # the replay before the stretch is not recorded
    assert sum(read[n] for n in NEW[:4]) == pytest.approx(np.mean(step_ms))
    idle = spans.idle_ms(s)
    assert sum(idle.values()) == pytest.approx(readings.T.gap_analysis(s.device)["idle"] * 1e-3 / 2)
    assert read["step.host_syncs"] >= 1.0
