"""Fleet parallelism: many odometry instances on one device or over several.

Port of ``mola_lidar_odometry_tpu/parallel/batch.py``.  On one device the
fleet is the explicit leading dimension B of every carry and scan tensor,
so the fleet step is the step itself (:func:`make_fleet_step`).

Over several devices (:class:`ShardedFleet`, the counterpart of
``make_shardmap_fleet_step``) the B instances are split
in instance order into one shard per device.  Each shard's carry lives on
its own device, owned by a worker process of its own
(``torch.multiprocessing``, spawn): every path of the port is bound by the
host issuing launches (about 1650 Python-issued launches per lidar3d-default
step), and Python threads issuing for N cards take turns under the GIL:
on four H100s one thread per card stepped 5.8x slower than one process per
card (``parallel/fleet_probe.py``).  Each step the scans are scattered to
the shards through pipes and the outputs gathered back in instance order;
as in the JAX design there are no collectives and no carry ever crosses
devices.

The point axis (:class:`PointShardedFleet`, the counterpart of
``make_sharded_fleet_step`` over a ``(fleet, point)`` :func:`make_mesh`)
splits each scan's padded points over the P cells of a mesh row, as
:func:`fleet_shardings` says: every cell owns a replica of its row's
carry and steps it on its slice of the scan, and the step's collectives
(``parallel/point_axis.py``) keep the replicas equal.  GSPMD places the
JAX package's collectives; here they are placed by hand: all-reduces for
the scan's reductions and the ICP's normal equations, a gather before the
first filter that reduces over the whole scan, and the fused path's kernels
run on every cell on the whole ICP layer.
"""

from __future__ import annotations

import time
import traceback
from typing import List, Optional, Sequence, Tuple

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
    return Scan(*(torch.from_numpy(a).to(device) for a in pack_host(spec, scans, stamps)))


def pack_host(spec: OdometrySpec, scans, stamps) -> Scan:
    """:func:`pack_scans` in numpy arrays on the host."""
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
    return Scan(xyz=xyz, time=tms, intensity=inten, ring=rng, valid=val, stamp=np.asarray(stamps, np.float32))


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


class _Workers:
    """Spawned worker processes, one pipe each, answered in order: the
    process lifetime both fleets share.  A worker that fails, ends or falls
    silent for ``answer_s`` ends them all."""

    answer_s = _ANSWER_S

    def _spawn(self, target, argss, names) -> None:
        """One spawned process per argument tuple (each gets its pipe end
        first), then wait until every one is ready."""
        ctx = torch.multiprocessing.get_context("spawn")
        self._conns, self._procs, self._names = [], [], list(names)
        try:
            for args in argss:
                parent, child = ctx.Pipe()
                proc = ctx.Process(target=target, args=(child,) + tuple(args), daemon=True)
                proc.start()
                child.close()
                self._conns.append(parent)
                self._procs.append(proc)
            self._gather()
        except BaseException:
            self.close()
            raise

    def _gather(self) -> list:
        """Every worker's answer, in worker order; the first error, end of
        pipe or missed deadline ends them all (a worker may wait in a
        collective for a peer that failed, so none is waited for alone)."""
        from multiprocessing.connection import wait

        deadline = time.monotonic() + self.answer_s
        got = {}
        pending = dict(zip(self._conns, range(len(self._conns))))
        while pending:
            ready = wait(list(pending), timeout=max(0.0, deadline - time.monotonic()))
            if not ready:
                self._abort(f"{self._names[min(pending.values())]} did not answer in {self.answer_s} s")
            for conn in ready:
                k = pending.pop(conn)
                try:
                    status, payload = conn.recv()
                except EOFError:
                    self._abort(f"{self._names[k]} ended")
                if status == "error":
                    self._abort(f"{self._names[k]} failed:\n{payload}")
                got[k] = payload
        return [got[k] for k in range(len(self._conns))]

    def _send_all(self, msgs) -> None:
        for k, (conn, msg) in enumerate(zip(self._conns, msgs)):
            try:
                conn.send(msg)
            except (BrokenPipeError, OSError):
                self._abort(f"{self._names[k]} ended")

    def _abort(self, why: str) -> None:
        """A worker failed or fell silent: the others' answers are unread
        and their carries a step ahead, so all end here and every later
        step raises."""
        for proc in self._procs:
            proc.kill()
        self.close()
        raise RuntimeError(why)

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

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class ShardedFleet(_Workers):
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
        self._spawn(_shard_worker, [(spec, self.per_shard, str(d), threads) for d in self.devices],
                    [f"fleet shard {i} ({d})" for i, d in enumerate(self.devices)])

    def step(self, scans, stamps) -> StepOutput:
        """One step of every instance: ``scans`` and ``stamps`` hold B
        entries in instance order (as :func:`pack_scans` takes them)."""
        if not self._procs:
            raise RuntimeError("step: the fleet is closed")
        if len(scans) != self.batch or len(stamps) != self.batch:
            raise ValueError(f"step: {len(scans)} scans and {len(stamps)} stamps for a fleet of {self.batch}")
        k = self.per_shard
        self._send_all(("step", list(scans[i * k:(i + 1) * k]), list(stamps[i * k:(i + 1) * k]))
                       for i in range(len(self._conns)))
        parts = self._gather()
        return StepOutput(*(np.concatenate(xs, axis=0) for xs in zip(*parts)))


# ---------------------------------------------------------------------------
# the point axis: make_mesh, fleet_shardings, PointShardedFleet
# ---------------------------------------------------------------------------

Mesh = List[List[str]]  # rows = the fleet axis, columns = the point axis; each entry a device name


def make_mesh(n_devices: Optional[int] = None, point_axis: int = 1, device: str = "cuda") -> Mesh:
    """A ``(fleet, point)`` grid of :func:`fleet_devices`: ``n_devices //
    point_axis`` rows of ``point_axis`` devices, filled row by row (the JAX
    ``make_mesh``'s ``reshape``, which refuses a count that does not
    divide)."""
    devs = fleet_devices(n_devices, device)
    if point_axis < 1 or len(devs) % point_axis:
        raise ValueError(f"make_mesh: {len(devs)} devices do not divide into rows of {point_axis}")
    return [devs[i:i + point_axis] for i in range(0, len(devs), point_axis)]


def _mesh_shape(mesh: Mesh) -> Tuple[int, int]:
    F, P = len(mesh), len(mesh[0]) if mesh else 0
    if F == 0 or P == 0 or any(len(row) != P for row in mesh):
        raise ValueError(f"a mesh is a non-empty grid of equal rows, got {mesh}")
    return F, P


def fleet_shardings(mesh: Mesh, carry: Carry, scan: Scan):
    """``(carry_specs, scan_specs)``: for each tensor a tuple naming the mesh
    axis each dimension splits on (``None``: not split), as the JAX
    ``fleet_shardings``' PartitionSpecs do.  The carry splits on ``fleet``
    only, so it is replicated over ``point``; ``(B, N, ...)`` scan tensors
    split on ``fleet x point``, ``(B,)`` ones on ``fleet``.  Raises when the
    point axis does not divide N or the fleet axis B."""
    F, P = _mesh_shape(mesh)

    def on_fleet(x):
        if x.shape[0] % F:
            raise ValueError(f"fleet_shardings: B = {x.shape[0]} does not divide over a fleet axis of {F}")
        return ("fleet",) + (None,) * (x.dim() - 1)

    def tree(x, fn):
        if torch.is_tensor(x):
            return fn(x)
        if isinstance(x, dict):
            return {k: tree(v, fn) for k, v in x.items()}
        if isinstance(x, tuple):
            items = [tree(v, fn) for v in x]
            return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
        return x

    def scan_spec(x):
        spec = on_fleet(x)
        if x.dim() >= 2:
            if x.shape[1] % P:
                raise ValueError(f"fleet_shardings: N = {x.shape[1]} points do not divide over a point axis of {P}")
            spec = ("fleet", "point") + spec[2:]
        return spec

    return tree(carry, on_fleet), tree(scan, scan_spec)


def _cell_part(x: np.ndarray, spec, row: int, col: int, F: int, P: int) -> np.ndarray:
    """Cell (row, col)'s part of ``x`` under ``spec`` (one of
    :func:`fleet_shardings`' tuples)."""
    for dim, name in enumerate(spec):
        if name is not None:
            k, at = (x.shape[dim] // F, row) if name == "fleet" else (x.shape[dim] // P, col)
            x = np.take(x, np.arange(at * k, (at + 1) * k), axis=dim)
    return np.ascontiguousarray(x)


def _launches() -> dict:
    from mola_lidar_odometry_tpu_torch.ops import pallas_capture, pallas_icp, pallas_match

    return {f.__name__: f.launches for f in (pallas_capture.capture_planar, pallas_capture.capture_planar_reselect,
                                             pallas_icp.align_fused, pallas_match.nn_select)}


def _cell_worker(conn, spec: OdometrySpec, F: int, P: int, row: int, col: int, device: str, backend: str,
                 address: str, threads: int, collective_s: float) -> None:
    """Cell (row, col) of a :class:`PointShardedFleet`: owns its replica of
    row ``row``'s carry (B = 1) on ``device`` and steps it on each
    ``("step", {field: its part})``, answering with the outputs (point rank
    0 only), the map replicas' hashes, the collectives of the step and the
    kernel launches so far; ``("close",)`` ends."""
    import datetime

    import torch.distributed as dist

    from mola_lidar_odometry_tpu_torch.parallel import point_axis as pa

    if threads:
        torch.set_num_threads(threads)
    try:
        if device.startswith("cuda"):
            torch.cuda.set_device(device)
        axis = None
        if P > 1:
            dist.init_process_group(backend, init_method=address, world_size=F * P, rank=row * P + col,
                                    timeout=datetime.timedelta(seconds=collective_s))
            groups = [dist.new_group(list(range(r * P, (r + 1) * P))) for r in range(F)]
            axis = pa.PointAxis(groups[row], col, P, via_host=backend == "gloo")
        fstep = step_mod.make_step(spec, axis=axis)
        carry = init_fleet_carry(spec, 1, device=device)
        conn.send(("ready", None))
    except Exception:  # report to the parent, which raises
        conn.send(("error", traceback.format_exc()))
        return
    try:
        while True:
            msg = conn.recv()
            if msg[0] == "close":
                if axis is not None:  # every cell is closing: none tears down the store under another
                    dist.barrier(device_ids=[torch.cuda.current_device()] if backend == "nccl" else None)
                break
            try:
                if msg[0] == "step":
                    part = msg[1]
                    scan = Scan(*(torch.from_numpy(part[f]).to(device) for f in Scan._fields))
                    carry, out = fstep(carry, scan)
                    hashes = pa.check_replicas(carry.maps, axis)
                    conn.send(("ok", dict(
                        out=StepOutput(*(t.cpu().numpy() for t in out)) if col == 0 else None,
                        map_hash=None if hashes is None else int(hashes[0, col]),
                        collectives={} if axis is None else axis.take_counts(),
                        launches=_launches(),
                    )))
                else:
                    conn.send(("error", f"unknown request {msg[0]!r}"))
            except Exception:  # the parent ends the fleet and raises
                conn.send(("error", traceback.format_exc()))
    finally:
        conn.close()
        if dist.is_initialized():
            dist.destroy_process_group()


def _free_address() -> str:
    import socket

    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return f"tcp://127.0.0.1:{s.getsockname()[1]}"


class PointShardedFleet(_Workers):
    """The JAX package's ``make_sharded_fleet_step`` over a ``(fleet,
    point)`` mesh (:func:`make_mesh`, or any grid of device names): one
    instance per mesh row (B is the fleet axis's length), each scan's N
    padded points split in order over the row's P cells
    (:func:`fleet_shardings`).  One spawned process per cell owns a replica
    of its row's carry; the cells of a row form one point group of a
    ``torch.distributed`` job: ``nccl`` when every cell has a card of its
    own, else ``gloo`` (the CPU, or cells sharing a card, whose collectives
    then pass through the host).  Every collective and every answer runs
    under ``answer_s``: a cell that fails or falls silent ends the whole
    fleet with an error.  ``step`` returns point rank 0's outputs of each
    row, numpy ``(B, ...)`` arrays in instance order; ``map_hashes`` holds
    the last step's map hash of every cell ``(F, P)`` (the step already
    raised if a row's differ), ``collectives`` each cell's ``{kind:
    (calls, bytes)}`` of that step and ``launches`` each cell's kernel
    launches so far.  Use it as a context manager, or call :meth:`close`."""

    def __init__(self, spec: OdometrySpec, mesh: Mesh, threads: int = 0, answer_s: float = None):
        F, P = _mesh_shape(mesh)
        if spec.raw_capacity % P:
            raise ValueError(f"N = {spec.raw_capacity} points do not divide over a point axis of {P}")
        cells = [str(d) for row in mesh for d in row]
        cuda = [d.startswith("cuda") for d in cells]
        if any(cuda):
            from mola_lidar_odometry_tpu_torch.ops import cuda_build

            cuda_build.build_all()  # once, before the workers load the kernels
        backend = "nccl" if all(cuda) and len(set(cells)) == len(cells) else "gloo"
        self.spec, self.mesh, self.shape, self.batch, self.backend = spec, mesh, (F, P), F, backend
        self.answer_s = answer_s or _ANSWER_S
        self.map_hashes, self.collectives, self.launches = None, None, None
        address = _free_address()
        self._spawn(_cell_worker,
                    [(spec, F, P, i, j, mesh[i][j], backend, address, threads, self.answer_s)
                     for i in range(F) for j in range(P)],
                    [f"mesh cell ({i}, {j}) ({mesh[i][j]})" for i in range(F) for j in range(P)])

    def step(self, scans, stamps) -> StepOutput:
        """One step of every instance: ``scans`` and ``stamps`` hold one
        entry per mesh row, in instance order (as :func:`pack_scans` takes
        them)."""
        if not self._procs:
            raise RuntimeError("step: the fleet is closed")
        F, P = self.shape
        if len(scans) != F or len(stamps) != F:
            raise ValueError(f"step: {len(scans)} scans and {len(stamps)} stamps for a fleet of {F}")
        self._send_all(("step", part) for part in self._parts(scans, stamps))
        parts = self._gather()
        self.map_hashes = [[parts[i * P + j]["map_hash"] for j in range(P)] for i in range(F)]
        self.collectives = [p["collectives"] for p in parts]
        self.launches = [p["launches"] for p in parts]
        rows = [parts[i * P]["out"] for i in range(F)]
        return StepOutput(*(np.concatenate(xs, axis=0) for xs in zip(*rows)))

    def _parts(self, scans, stamps) -> list:
        """Every cell's part of the packed scans, in cell order."""
        F, P = self.shape
        host = pack_host(self.spec, scans, stamps)
        _, specs = fleet_shardings(self.mesh, None, Scan(*(torch.from_numpy(a) for a in host)))
        return [{f: _cell_part(getattr(host, f), getattr(specs, f), i, j, F, P) for f in Scan._fields}
                for i in range(F) for j in range(P)]
