"""The system under test: the port's fleet step over one cell's scans.

Set-up makes the cell's scans on the device from the seed, sizes the
pipeline with ``utils/capacity.py`` on the densest first scan of the fleet
(the largest scan of the cell as the raw size), builds the fleet step and
warms it up.  The window then steps the fleet in episodes: every
instance over its own frames from a fresh carry, episode after episode,
each step issued once the previous one's outputs are on the host.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, List, Optional

import numpy as np

from port_bench.gen import raycast, world as gen_world

ROOT = Path(__file__).resolve().parents[2]
BENCH = Path(__file__).resolve().parents[1]
# the fields each step reads back, packed into one float32 row per instance
FIELDS = ("R", 9), ("t", 3), ("quality", 1), ("iterations", 1), ("kf_local", 1), ("accepted", 1), \
    ("n_icp_layer", 1), ("n_map_layer", 1)
COLUMNS = {}
_at = 0
for _name, _width in FIELDS:
    COLUMNS[_name] = slice(_at, _at + _width)
    _at += _width


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    settings: dict  # the cell's own file: warm-up, reference sample, limits, trace stretch


@dataclass
class Program:
    spec: object
    step: Callable
    scans: list  # per frame, a port ``Scan`` of the whole fleet
    stamps: List[float]  # per frame, the scans' stamp (float32 values)
    trajs: list  # per instance, the generator's ground truth
    batch: int
    frames: int
    host_scans: Callable  # instance -> [(xyz, time)] of valid points, float64
    device: str


@dataclass
class Window:
    seconds: float = 0.0
    steps: int = 0
    episodes: int = 0  # completed
    step_ms: List[float] = field(default_factory=list)
    issue_s: float = 0.0
    rows: List[np.ndarray] = field(default_factory=list)  # per step, (B, len(FIELDS)) float32
    peak_bytes: int = 0


def load_cell(workload: str, root: Path = ROOT) -> Cell:
    """The cell ``workload`` of ``BENCHMARK.json``, with its configuration,
    traffic mix and settings files, found by name."""
    import json

    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"port_bench: no workload {workload!r} in BENCHMARK.json ({', '.join(cells)})")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text())
    settings = json.loads((BENCH / "cells" / f"{workload}.json").read_text())
    return Cell(workload, config, traffic, settings)


def build(cell: Cell, seed: int, device: str, log=print) -> Program:
    import torch

    from mola_lidar_odometry_tpu_torch.models.spec import spec_from_yaml
    from mola_lidar_odometry_tpu_torch.models.step import Scan
    from mola_lidar_odometry_tpu_torch.parallel import batch as pb
    from mola_lidar_odometry_tpu_torch.utils.capacity import derive_capacities
    from mola_lidar_odometry_tpu_torch.utils.config import load_yaml_file

    tr, sensor = cell.traffic, cell.traffic["sensor"]
    t0 = time.perf_counter()
    world, trajs, drives = gen_world.fleet(seed, tr)
    t1 = time.perf_counter()
    frames, most = raycast.fleet_scans(world, trajs, sensor, gen_world.noise_seeds(seed, tr, drives), device)
    t2 = time.perf_counter()
    cfg = load_yaml_file(BENCH / cell.config["pipeline"], env={})
    spec0 = spec_from_yaml(cfg)
    i0 = densest_first_scan(spec0, frames[0])
    v0 = frames[0][3][i0]
    x0 = frames[0][0][i0][v0].double().cpu().numpy()
    tm0 = frames[0][1][i0][v0].double().cpu().numpy()
    raw, slots, caps, budgets = derive_capacities(spec0, x0, tm0, with_budgets=True, known_max_points=most)
    spec = spec_from_yaml(cfg, raw_capacity=raw, map_slots=slots, layer_capacities=caps, insert_budgets=budgets,
                          kf_ring_capacity=cell.config["kf_ring_capacity"])
    B, F = tr["instances"], tr["frames"]
    zeros = torch.zeros((B, raw), dtype=torch.float32, device=device)
    stamps = [float(np.float32(k / sensor["rate_hz"])) for k in range(F)]
    scans = []
    for k in range(F):
        xyz, tm, ring, valid = (a[:, :raw].contiguous() for a in frames[k])
        frames[k] = None
        stamp = torch.full((B,), stamps[k], dtype=torch.float32, device=device)
        scans.append(Scan(xyz=xyz, time=tm, intensity=zeros, ring=ring, valid=valid, stamp=stamp))
    log(f"set-up: town and {B} paths {t1 - t0:.2f} s, {B * F} scans of {sensor['rings']}x{sensor['azimuths']} rays "
        f"{t2 - t1:.2f} s (largest {most} points); sized on instance {i0}: raw={raw} slots={slots} layers={caps} "
        f"budgets={budgets}")

    def host_scans(i: int):
        out = []
        for s in scans:
            v = s.valid[i]
            out.append((s.xyz[i][v].double().cpu().numpy(), s.time[i][v].double().cpu().numpy()))
        return out

    return Program(spec, pb.make_fleet_step(spec), scans, stamps, trajs, B, F, host_scans, device)


def densest_first_scan(spec, frame0) -> int:
    """The instance whose first scan fills the most voxels at the pipeline's
    first decimation.  ``bench.py`` sizes its one sequence from its first
    scan; a fleet in one town is sized from its densest first scan, so that
    no instance's layers overflow where another's would not."""
    import torch

    from mola_lidar_odometry_tpu_torch.models.filter_graph import DecimateOp

    xyz, _, _, valid = frame0
    op = next((o for o in spec.filter1 if isinstance(o, DecimateOp)), None)
    if op is None:
        return 0
    counts = []
    for i in range(xyz.shape[0]):
        p = xyz[i][valid[i]].double()
        r = max(float(torch.linalg.norm(p, dim=-1).max()), spec.absolute_minimum_sensor_range)
        env = dict.fromkeys(("vx", "vy", "vz", "wx", "wy", "wz", "ICP_ITERATION", "icp_iterations"), 0.0)
        env.update(ESTIMATED_SENSOR_MAX_RANGE=r, INSTANTANEOUS_SENSOR_MAX_RANGE=r,
                   ADAPTIVE_THRESHOLD_SIGMA=spec.adaptive_threshold.initial_sigma)
        keys = torch.floor(p / float(op.resolution(env))).to(torch.int64)
        counts.append(int(torch.unique(keys, dim=0).shape[0]))
    return int(np.argmax(counts))


def fresh_carry(prog: Program):
    from mola_lidar_odometry_tpu_torch.parallel import batch as pb

    return pb.init_fleet_carry(prog.spec, prog.batch, device=prog.device)


def readback(out) -> np.ndarray:
    """The step's outputs the harness reads, on the host: one copy."""
    import torch

    B = out.pose_t.shape[0]
    cols = [out.pose_R.reshape(B, 9), out.pose_t, out.quality[:, None], out.iterations[:, None], out.kf_local[:, None],
            out.accepted[:, None], out.n_icp_layer[:, None], out.n_map_layer[:, None]]
    return torch.cat([c.to(torch.float32) for c in cols], dim=1).cpu().numpy()


def warm_up(prog: Program, steps: int) -> None:
    """The cell's first ``steps`` frames from a fresh carry, read back as the
    window reads them: every kernel built and loaded, the allocator's pools
    filled for the shapes the window uses."""
    carry = fresh_carry(prog)
    for k in range(steps):
        carry, out = prog.step(carry, prog.scans[k])
        readback(out)


def run_window(prog: Program, seconds: float, min_episodes: int = 0) -> Window:
    """Episodes back to back until ``seconds`` have passed (and at least
    ``min_episodes`` have completed); the window ends with the step that
    crosses it."""
    import torch

    w = Window()
    if prog.device.startswith("cuda"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    carry = fresh_carry(prog)
    k = 0
    start = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        carry, out = prog.step(carry, prog.scans[k])
        t1 = time.perf_counter()
        w.rows.append(readback(out))
        t2 = time.perf_counter()
        w.step_ms.append((t2 - t0) * 1e3)
        w.issue_s += t1 - t0
        w.steps += 1
        k += 1
        if k == prog.frames:
            w.episodes += 1
            k = 0
            carry = fresh_carry(prog)
        if t2 - start >= seconds and w.episodes >= min_episodes:
            break
    w.seconds = t2 - start
    if prog.device.startswith("cuda"):
        w.peak_bytes = int(torch.cuda.max_memory_allocated())
    return w


def replay(prog: Program, frames: int):
    """The carry after the first ``frames`` steps of a fresh episode."""
    carry = fresh_carry(prog)
    for k in range(frames):
        carry, out = prog.step(carry, prog.scans[k])
        readback(out)
    return carry


def timed_stretch(prog: Program, start_frame: int, steps: int) -> float:
    """Host seconds of the steps that ``traced_stretch`` traces, untraced:
    from the first step's call to the last one's outputs on the host."""
    carry = replay(prog, start_frame)
    t0 = time.perf_counter()
    for k in range(start_frame, start_frame + steps):
        carry, out = prog.step(carry, prog.scans[k])
        readback(out)
    return time.perf_counter() - t0


def traced_stretch(prog: Program, start_frame: int, steps: int, tmpdir: str, stacks: bool):
    """``steps`` steps from frame ``start_frame`` of a fresh episode under
    ``torch.profiler``: ``(trace dict, wall seconds, recorder)``.  With
    ``stacks`` it records host ops and their Python stacks, and the kernel
    wrappers' calls, to say what launched each device op; that slows the
    host's issue of the step several-fold.  Without, on the card it records
    the device's activity alone, so the device line keeps the gaps of an
    untraced step."""
    import contextlib
    import json
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    from port_bench.harness.work import Recorder

    carry = replay(prog, start_frame)
    cuda = prog.device.startswith("cuda")
    if stacks or not cuda:
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    else:
        acts = [ProfilerActivity.CUDA]
    rec = Recorder()
    with rec() if stacks else contextlib.nullcontext(), profile(activities=acts, with_stack=stacks) as prof:
        t0 = time.perf_counter()
        for k in range(start_frame, start_frame + steps):
            carry, out = prog.step(carry, prog.scans[k])
            readback(out)
        wall = time.perf_counter() - t0
    path = os.path.join(tmpdir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    os.remove(path)
    return trace, wall, rec


def window_array(w: Window, batch: int, frames: int) -> Optional[np.ndarray]:
    """The completed episodes' rows, ``(episodes, frames, B, columns)``."""
    n = w.episodes * frames
    if n == 0:
        return None
    return np.stack(w.rows[:n]).reshape(w.episodes, frames, batch, -1)
