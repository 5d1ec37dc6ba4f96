"""Fleet parallelism: many odometry instances on one device or over several.

Port of ``mola_lidar_odometry_tpu/parallel/batch.py``.  On one device the
fleet is the explicit leading dimension B of every carry and scan tensor,
so the fleet step is the step itself (:func:`make_fleet_step`).

Over several devices (:class:`ShardedFleet`, the counterpart of
``make_shardmap_fleet_step`` and ``make_mesh``) the B instances are split
in instance order into one shard per device.  Each shard's carry lives on
its own device, owned by a worker process of its own
(``torch.multiprocessing``, spawn): every path of the port is bound by the
host issuing launches (about 1650 Python-issued launches per lidar3d-default
step), and Python threads issuing for N cards take turns under the GIL:
on four H100s one thread per card stepped 5.8x slower than one process per
card (``parallel/fleet_probe.py``).  Each step the scans are scattered to
the shards through pipes and the outputs gathered back in instance order;
as in the JAX design there are no collectives and no carry ever crosses
devices.  The JAX package's GSPMD point-axis lowering
(``make_sharded_fleet_step``) is not ported: it needs collectives across
two or more cards (ROADMAP).
"""

from __future__ import annotations

import traceback
from typing import List, Optional, Sequence

import numpy as np
import torch

from mola_lidar_odometry_tpu_torch.models import step as step_mod
from mola_lidar_odometry_tpu_torch.models.spec import OdometrySpec
from mola_lidar_odometry_tpu_torch.models.step import Carry, Scan, StepOutput


def init_fleet_carry(spec: OdometrySpec, batch: int, device="cuda") -> Carry:
    """``batch`` fresh carries stacked on the leading dimension."""
    return step_mod.init_carry(spec, batch, device)


def make_fleet_step(spec: OdometrySpec):
    """(Carry[B], Scan[B]) -> (Carry[B], StepOutput[B])."""
    return step_mod.make_step(spec)


def pack_scans(spec: OdometrySpec, scans, stamps, device="cuda") -> Scan:
    """Pad a list of (xyz, times, rings, valid[, intensity]) numpy scans
    into a batched Scan (intensity 0 where a scan has none)."""
    b, n = len(scans), spec.raw_capacity
    xyz = np.zeros((b, n, 3), np.float32)
    tms = np.zeros((b, n), np.float32)
    inten = np.zeros((b, n), np.float32)
    rng = np.zeros((b, n), np.int32)
    val = np.zeros((b, n), bool)
    for i, (x, t, r, v, *rest) in enumerate(scans):
        k = min(len(x), n)
        xyz[i, :k], tms[i, :k], rng[i, :k], val[i, :k] = x[:k], t[:k], r[:k], v[:k]
        if rest:
            inten[i, :k] = rest[0][:k]

    def dev(a):
        return torch.from_numpy(a).to(device)

    return Scan(
        xyz=dev(xyz), time=dev(tms), intensity=dev(inten), ring=dev(rng), valid=dev(val),
        stamp=dev(np.asarray(stamps, np.float32)),
    )


def fleet_devices(n_devices: Optional[int] = None, device: str = "cuda") -> List[str]:
    """The devices a :class:`ShardedFleet` spreads over (``make_mesh``'s
    counterpart): the first ``n_devices`` visible cards (all of them by
    default); ``device="cpu"`` gives ``n_devices`` CPU shards.  Raises when
    fewer cards are visible than asked for."""
    if device == "cpu":
        return ["cpu"] * (n_devices or 1)
    n_vis = torch.cuda.device_count()
    n = n_devices or n_vis
    if n_vis == 0 or n > n_vis:
        raise RuntimeError(f"fleet_devices: {n} CUDA device(s) asked for, {n_vis} visible")
    return [f"cuda:{i}" for i in range(n)]


_ANSWER_S = 600.0  # how long a step of a shard may take before the fleet gives up on it


def _shard_worker(conn, spec: OdometrySpec, batch: int, device: str, threads: int) -> None:
    """One shard's process: owns its carry on ``device``, steps it on each
    ``("step", scans, stamps)`` and answers with the outputs on the host;
    ``("close",)`` ends."""
    if threads:
        torch.set_num_threads(threads)
    try:
        if device.startswith("cuda"):
            torch.cuda.set_device(device)
        fstep = make_fleet_step(spec)
        carry = init_fleet_carry(spec, batch, device=device)
        conn.send(("ready", None))
    except Exception:  # report to the parent, which raises
        conn.send(("error", traceback.format_exc()))
        return
    while True:
        msg = conn.recv()
        if msg[0] == "close":
            break
        try:
            if msg[0] == "step":
                carry, out = fstep(carry, pack_scans(spec, msg[1], msg[2], device=device))
                conn.send(("ok", StepOutput(*(t.cpu().numpy() for t in out))))
            else:
                conn.send(("error", f"unknown request {msg[0]!r}"))
        except Exception:  # the parent ends the fleet and raises
            conn.send(("error", traceback.format_exc()))
    conn.close()


class ShardedFleet:
    """``batch`` odometry instances split over ``devices`` in instance
    order, ``batch // len(devices)`` per shard, each shard stepped by a
    worker process that owns its carry (a device may be named twice: two
    processes then share it).  ``step`` scatters the B scans, steps every
    shard at once and gathers the outputs, numpy ``(B, ...)`` arrays in
    instance order.  A shard that fails or falls silent ends the whole
    fleet.  Use it as a context manager, or call :meth:`close`."""

    def __init__(self, spec: OdometrySpec, batch: int, devices: Sequence[str], threads: int = 0):
        n = len(devices)
        if n == 0 or batch % n:
            raise ValueError(f"batch {batch} must divide over the {n} devices of the fleet")
        if any(str(d).startswith("cuda") for d in devices):
            from mola_lidar_odometry_tpu_torch.ops import cuda_build

            cuda_build.build_all()  # once, before the workers load the kernels
        self.spec, self.batch, self.devices, self.per_shard = spec, batch, list(devices), batch // n
        ctx = torch.multiprocessing.get_context("spawn")
        self._conns, self._procs = [], []
        try:
            for d in self.devices:
                parent, child = ctx.Pipe()
                proc = ctx.Process(target=_shard_worker, args=(child, spec, self.per_shard, str(d), threads),
                                   daemon=True)
                proc.start()
                child.close()
                self._conns.append(parent)
                self._procs.append(proc)
            self._gather()  # every shard built its carry
        except BaseException:
            self.close()
            raise

    def _gather(self) -> list:
        out = []
        for i, conn in enumerate(self._conns):
            where = f"fleet shard {i} ({self.devices[i]})"
            if not conn.poll(_ANSWER_S):
                self._abort(f"{where} did not answer in {_ANSWER_S} s")
            try:
                status, payload = conn.recv()
            except EOFError:
                self._abort(f"{where} ended")
            if status == "error":
                self._abort(f"{where} failed:\n{payload}")
            out.append(payload)
        return out

    def _abort(self, why: str) -> None:
        """A shard failed or fell silent: the other shards' answers are
        unread and their carries a step ahead, so the fleet ends here and
        every later :meth:`step` raises."""
        for proc in self._procs:
            proc.kill()
        self.close()
        raise RuntimeError(why)

    def step(self, scans, stamps) -> StepOutput:
        """One step of every instance: ``scans`` and ``stamps`` hold B
        entries in instance order (as :func:`pack_scans` takes them)."""
        if not self._procs:
            raise RuntimeError("step: the fleet is closed")
        if len(scans) != self.batch or len(stamps) != self.batch:
            raise ValueError(f"step: {len(scans)} scans and {len(stamps)} stamps for a fleet of {self.batch}")
        k = self.per_shard
        for i, conn in enumerate(self._conns):
            conn.send(("step", list(scans[i * k:(i + 1) * k]), list(stamps[i * k:(i + 1) * k])))
        parts = self._gather()
        return StepOutput(*(np.concatenate(xs, axis=0) for xs in zip(*parts)))

    def close(self) -> None:
        for conn in self._conns:
            try:
                conn.send(("close",))
            except (BrokenPipeError, OSError):
                pass
        for proc in self._procs:
            proc.join(timeout=30)
            if proc.is_alive():
                proc.kill()
                proc.join()
        for conn in self._conns:
            conn.close()
        self._conns, self._procs = [], []

    def __enter__(self) -> "ShardedFleet":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
