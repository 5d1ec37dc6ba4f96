"""The benchmark of mola_lidar_odometry_tpu_torch: one cell, one run.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Finds the cell in ``BENCHMARK.json`` and its configuration, traffic mix
and settings under ``port_bench/`` by name; makes the cell's scans on the
card from the seed; builds and warms up the port's fleet step (set-up);
steps the fleet in episodes for ``--seconds`` (the window); with
``--trace 1`` profiles a short stretch of steps after it; then judges the
window's last episode against the plain reference.  Prints the numbers
judged and their limits as the last lines of standard error, and one JSON
line as the last line of standard output.

Exits with 2, printing no result, without as many CUDA devices as the cell
asks for, and with 3 if JAX or the JAX package got loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# top-level module names that may not be loaded in a run (compared whole:
# the port's package name only begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "mola_lidar_odometry_tpu")


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))


def reader(name: str):
    spec = importlib.util.spec_from_file_location(f"port_bench_metric_{name.replace('.', '_')}",
                                                  BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def run_cell(bench: dict, cell, seed: int, seconds: float, trace: bool, device: str, t_start: float,
             wrap_step=None):
    """One run of ``cell`` on ``device``: ``(result, check lines)``.
    ``wrap_step`` replaces the fleet step by ``wrap_step(step)`` (tests)."""
    import numpy as np
    import torch

    from port_bench.harness import accuracy, check, program, readings

    s = cell.settings
    prog = program.build(cell, seed, device, log=log)
    if wrap_step is not None:
        prog.step = wrap_step(prog.step)
    program.warm_up(prog, s["warmup_steps"])
    if device.startswith("cuda"):
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    w = program.run_window(prog, seconds)
    rows = np.stack(w.rows)
    episodes = program.window_array(w, prog.batch, prog.frames)
    found = {
        "scans_per_s": prog.batch * w.steps / w.seconds,
        "step_ms_p95": float(np.percentile(w.step_ms, 95)),
        "setup_s": setup_s,
    }
    if episodes is not None:
        found["ate_rmse_m"] = accuracy.ate_rmse(episodes, prog.trajs)
    log(f"window: {w.steps} steps ({w.episodes} episodes) in {w.seconds:.3f} s; step median "
        f"{float(np.median(w.step_ms)):.3f} ms; issue {1e3 * w.issue_s / w.steps:.3f} ms a step")
    result_device = {"platform": "gpu" if device.startswith("cuda") else "cpu",
                     "kind": torch.cuda.get_device_name(0) if device.startswith("cuda") else "cpu",
                     "count": 1, "memory_peak_bytes": w.peak_bytes}
    r = readings.Readings(w, rows)
    breakdown = None
    if trace:
        ts = s["trace"]
        untraced = program.timed_stretch(prog, ts["start_frame"], ts["steps"])
        with tempfile.TemporaryDirectory() as tmp:
            tr, wall, _ = program.traced_stretch(prog, ts["start_frame"], ts["steps"], tmp, stacks=False)
            r.timeline = readings.timeline(tr, ts["steps"], wall, untraced)
            tr, wall, rec = program.traced_stretch(prog, ts["start_frame"], ts["steps"], tmp, stacks=True)
            r.traced = readings.traced(tr, ts["steps"], wall, rec)
        del tr
        result_device.update(busy_s=r.timeline.busy_s, window_s=r.timeline.span_s)
        breakdown = readings.breakdown(r.timeline, r.traced)
        log(f"trace: {ts['steps']} steps without stacks: {len(r.timeline.events)} device ops, busy "
            f"{r.timeline.busy_s:.6f} s of a {r.timeline.span_s:.6f} s device span ({r.timeline.wall_s:.6f} s on the "
            f"host, {untraced:.6f} s untraced); with stacks {r.traced.wall_s:.6f} s on the host; kernel bounds (ms) "
            f"{rec.bound_ms_by_kind() if rec.complete else {}}")
    metrics = {}
    for m in bench["per_layer" if trace else "end_to_end"]:
        if not applies(m, cell.name):
            continue
        v = reader(m["name"])(r) if trace else found.get(m["name"])
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    # the reference's inputs are copied before the program's state goes
    sample = check.sample_instances(seed, prog.batch, s["reference_instances"])
    sequences = {i: prog.host_scans(i) for i in sample}
    failed = int((rows[..., program.COLUMNS["accepted"]] < 0.5).sum())
    attempted = int(rows.shape[0] * rows.shape[1])
    stamps, trajs, batch = prog.stamps, prog.trajs, prog.batch
    del prog, r
    if device.startswith("cuda"):
        torch.cuda.empty_cache()
    if episodes is None:
        ok, lines = False, [("completed_episodes", 0.0, 1.0)]
    else:
        t_ref = time.perf_counter()
        ref = check.run_reference(str(BENCH / cell.config["pipeline"]), sequences, stamps)
        numbers = check.numbers(episodes[-1], ref, trajs)
        ok, lines = check.judge(numbers, s["limits"])
        log("record: " + ", ".join(f"{k} {v!r}" for k, v in numbers.items() if k not in s["limits"]))
        log(f"reference: {len(ref)} instances of {batch} ({sample}) in {time.perf_counter() - t_ref:.1f} s")
    result = {"correct": bool(ok), "attempted": attempted, "failed": failed, "metrics": metrics,
              "device": result_device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {name: {"value": float(v), "limit": float(lim)} for name, v, lim in lines}
    return result, lines


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every build and kernel cache at a fixed path inside the checkout
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / "build" / sub)
    sys.path.insert(0, str(ROOT))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    from port_bench.harness.program import load_cell

    cell = load_cell(args.workload)
    chips = next(w["chips"] for w in bench["workloads"] if w["name"] == args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"port_bench: the cell needs {chips} CUDA device(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible")
        return 2
    log(f"card: {card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    result, lines = run_cell(bench, cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    bad = forbidden_modules()
    if bad:
        log(f"port_bench: loaded in this process, and not allowed: {', '.join(bad)}")
        return 3
    for name, v, lim in lines:
        log(f"check: {name} {v!r} (limit {lim!r})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
