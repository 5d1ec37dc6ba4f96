"""How the fleet scales over several cards: one process against one worker
process per card (:class:`batch.ShardedFleet`) against one Python thread
per card.

Every mode steps lidar3d-default instances, sized from the first scan as
``apps/fleet_eval.py`` sizes them, over the same frames; instance b runs
the simulated sequence b % per_device (world seed b, trajectory seed
100 + b), so only ``per_device`` sequences are simulated:

  * ``alone``: ``per_device`` instances in this process on the first card,
    the rate one card reaches by itself;
  * ``one card``: all ``per_device * N`` instances in this process on the
    first card;
  * ``processes``: :class:`batch.ShardedFleet` over the N cards;
  * ``threads``: N threads of this process, each stepping the shard of one
    card, which it owns, joined after every step.

Every mode brings each step's outputs to the host, as ShardedFleet must.
Prints one JSON line: each mode's seconds for each step, the median over
frames 2..F-1 (a fresh process loads its kernels and fills its allocator in
the first steps), its scans per second at that median, and whether its
outputs equal the ``one card`` mode's bit for bit.

    python -m mola_lidar_odometry_tpu_torch.parallel.fleet_probe [--devices N] [--per-device 8] [--frames 6]
    python -m mola_lidar_odometry_tpu_torch.parallel.fleet_probe --device cpu --devices 2 --per-device 2 \\
        --frames 3 --rings 8 --azimuth 256
"""

from __future__ import annotations

import argparse
import json
import os
import time
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..")


def _to_host(out):
    from mola_lidar_odometry_tpu_torch.models.step import StepOutput

    return StepOutput(*(t.cpu().numpy() for t in out))


def _timed(feed, batch: int, step):
    """(seconds of each step, outputs of each step) of ``step(scans,
    stamps)`` over the feed."""
    secs, outs = [], []
    for scans, stamps in feed(batch):
        t0 = time.perf_counter()
        outs.append(step(scans, stamps))
        secs.append(time.perf_counter() - t0)
    return secs, outs


def _in_process(spec, feed, device: str, batch: int):
    """Step ``batch`` instances in this process."""
    from mola_lidar_odometry_tpu_torch.parallel import batch as pb

    fstep = pb.make_fleet_step(spec)
    carry = [pb.init_fleet_carry(spec, batch, device=device)]

    def step(scans, stamps):
        carry[0], out = fstep(carry[0], pb.pack_scans(spec, scans, stamps, device=device))
        return _to_host(out)

    return _timed(feed, batch, step)


def _threads(spec, feed, devices, batch: int):
    """One thread per device, each stepping (and owning) its shard."""
    import torch

    from mola_lidar_odometry_tpu_torch.models.step import StepOutput
    from mola_lidar_odometry_tpu_torch.parallel import batch as pb

    n = len(devices)
    k_sh = batch // n
    fsteps = [pb.make_fleet_step(spec) for _ in devices]  # nothing shared between the threads but the spec
    carries = [pb.init_fleet_carry(spec, k_sh, device=d) for d in devices]

    def shard(i, scans, stamps):
        d = devices[i]
        if d.startswith("cuda"):
            torch.cuda.set_device(d)
        carries[i], out = fsteps[i](carries[i], pb.pack_scans(spec, scans[i * k_sh:(i + 1) * k_sh],
                                                          stamps[i * k_sh:(i + 1) * k_sh], device=d))
        return _to_host(out)

    with ThreadPoolExecutor(max_workers=n) as pool:

        def step(scans, stamps):
            parts = list(pool.map(lambda i: shard(i, scans, stamps), range(n)))
            return StepOutput(*(np.concatenate(xs, axis=0) for xs in zip(*parts)))

        return _timed(feed, batch, step)


def _processes(spec, feed, devices, batch: int, threads: int):
    from mola_lidar_odometry_tpu_torch.parallel import batch as pb

    with pb.ShardedFleet(spec, batch, devices, threads=threads) as fleet:
        return _timed(feed, batch, fleet.step)


def _equal(outs, ref) -> bool:
    """Every field of every step equals the reference's first instances."""
    for o, r in zip(outs, ref):
        for a, b in zip(o, r):
            if not np.array_equal(a, b[: a.shape[0]]):
                return False
    return len(outs) == len(ref)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="fleet_probe", description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", type=int, default=0, help="cards to split over; 0 = every visible card")
    ap.add_argument("--per-device", type=int, default=8, help="instances per card (simulated sequences)")
    ap.add_argument("--frames", type=int, default=6)
    ap.add_argument("--rings", type=int, default=32)
    ap.add_argument("--azimuth", type=int, default=1024)
    ap.add_argument("--pipeline", default=os.path.join(ROOT, "pipelines", "lidar3d-default.yaml"))
    ap.add_argument("--device", default="cuda", help="cuda (default; raises without a card) or cpu")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    import torch

    from mola_lidar_odometry_tpu_torch.apps import fleet_eval
    from mola_lidar_odometry_tpu_torch.parallel import batch as pb
    from mola_lidar_odometry_tpu_torch.utils.config import load_yaml_file

    if args.device != "cpu" and not torch.cuda.is_available():
        raise SystemExit("fleet_probe: no CUDA device visible; pass --device cpu to run on the CPU")
    devices = pb.fleet_devices(args.devices or None, args.device)
    n, k = len(devices), args.per_device
    trajs, stacks = fleet_eval.simulate_fleet(k, args.frames, args.rings, args.azimuth)
    sizing = SimpleNamespace(map_slots=0)
    spec = fleet_eval.fleet_spec(load_yaml_file(args.pipeline, env={}), sizing, stacks)
    if args.device == "cpu":
        torch.set_num_threads(1)
    else:
        from mola_lidar_odometry_tpu_torch.ops import cuda_build

        cuda_build.build_all()

    def feed(batch):
        for f in range(args.frames):
            yield [stacks[b % k][f] for b in range(batch)], [trajs[b % k].stamps[f] for b in range(batch)]

    B = n * k
    modes = {}
    secs, ref = _in_process(spec, feed, devices[0], B)
    modes["one card"] = (secs, B, True)
    secs, outs = _in_process(spec, feed, devices[0], k)
    modes["alone"] = (secs, k, _equal(outs, ref))
    secs, outs = _processes(spec, feed, devices, B, threads=1 if args.device == "cpu" else 0)
    modes["processes"] = (secs, B, _equal(outs, ref))
    secs, outs = _threads(spec, feed, devices, B)
    modes["threads"] = (secs, B, _equal(outs, ref))
    result = {
        "devices": n, "per_device": k, "frames": args.frames, "points_per_scan": args.rings * args.azimuth,
        "device": args.device if args.device == "cpu" else torch.cuda.get_device_name(0),
        "modes": {},
    }
    for m, (secs, b, eq) in modes.items():
        med = float(np.median(secs[2:] if len(secs) > 2 else secs))
        result["modes"][m] = {"s_per_step": med, "instances": b, "scans_per_s": b / med, "equal": eq,
                              "step_s": secs}
    print(json.dumps(result))
    return 0 if all(eq for _, _, eq in modes.values()) else 1


if __name__ == "__main__":
    raise SystemExit(main())
