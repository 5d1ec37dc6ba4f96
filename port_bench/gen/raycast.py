"""The fleet's scans, ray cast on the device in plain torch.

``utils/sim.py::simulate_scan`` rewritten for many scans at once: the
sensor spins once a scan, each azimuth column is cast from the vehicle's
pose at that column's own time (so every scan carries motion distortion for
the deskew), the rough ground is hit from above, and each box is met by a
slab test in its own frame.  The arithmetic is the simulator's, in float64;
what is new is which ray meets which box: a column's rays all lie in one
plane through the sensor, so a box whose bounding sphere misses that plane
(or lies behind the sensor, or out of range) is never tested against it,
and of the rest only the rings whose elevations can reach the sphere are.
That keeps the exact result and tests a few per cent of the ray-box pairs.

Each drive's range noise comes from a ``torch.Generator`` on the device of
its own, seeded from the run's seed, the town and the drive: one seed gives
the same scans again on the same kind of device, another seed the same
drives with other noise.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch

GROUND_AMP = 0.04  # m, the simulator's asphalt roughness
GROUND_CELL = 0.75  # m
TESTS_PER_CHUNK = 1 << 23  # ray-box tests held at once
SCANS_PER_CULL = 8  # scans whose (column, box) pairs are culled at once


def sensor_grid(sensor: dict, device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Unit ray directions in the sensor frame ``(H, W, 3)``, the ring
    elevations ``(H,)`` and each column's time from mid-scan ``(W,)``, as
    the simulator's ``linspace`` gives them."""
    H, W = sensor["rings"], sensor["azimuths"]
    f64 = torch.float64
    az = torch.arange(W, dtype=f64, device=device) * (2 * math.pi / W) - math.pi
    lo, hi = math.radians(sensor["fov_down_deg"]), math.radians(sensor["fov_up_deg"])
    el = torch.arange(H, dtype=f64, device=device) * ((hi - lo) / (H - 1)) + lo
    el[-1] = hi
    ce = torch.cos(el)[:, None]
    dirs = torch.stack([ce * torch.cos(az), ce * torch.sin(az), torch.sin(el)[:, None].expand(H, W)], dim=-1)
    col_time = az / (2 * math.pi) / sensor["rate_hz"]
    return dirs, el, col_time


def so3_exp(phi: torch.Tensor) -> torch.Tensor:
    """Rodrigues' formula over ``(..., 3)``; the identity below 1e-12 rad."""
    th = torch.linalg.norm(phi, dim=-1, keepdim=True)
    a = phi / torch.where(th < 1e-12, 1.0, th)
    z = torch.zeros_like(a[..., 0])
    K = torch.stack([z, -a[..., 2], a[..., 1], a[..., 2], z, -a[..., 0], -a[..., 1], a[..., 0], z],
                    dim=-1).view(*a.shape[:-1], 3, 3)
    s, c = torch.sin(th)[..., None], torch.cos(th)[..., None]
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device)
    return torch.where(th[..., None] < 1e-12, eye, eye + s * K + (1 - c) * (K @ K))


def column_poses(R, t, twist, col_time):
    """Each column's sensor pose ``(S, W, 3, 3)``, ``(S, W, 3)`` from the
    scans' mid-scan poses and twists (``pose_advance`` at the column's time)."""
    dt = col_time[None, :, None]
    Rd = so3_exp(twist[:, None, 3:] * dt)
    Rc = R[:, None] @ Rd
    tc = t[:, None] + (R[:, None] @ (twist[:, None, :3] * dt)[..., None])[..., 0]
    return Rc, tc


def ground_height(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The simulator's world-anchored roughness (an integer-cell hash)."""
    cx = torch.floor(x / GROUND_CELL).to(torch.int64)
    cy = torch.floor(y / GROUND_CELL).to(torch.int64)
    h = (cx * 73856093) ^ (cy * 19349663)
    h = (h ^ (h >> 13)) * 0x5BD1E995
    u = ((h ^ (h >> 15)) & 0xFFFF).to(torch.float64) / 65535.0
    return (u - 0.5) * 2.0 * GROUND_AMP


def ground_hits(o: torch.Tensor, d: torch.Tensor, ground_z: float) -> torch.Tensor:
    """Distance to the rough ground along each ray (inf where it misses)."""
    dz = d[..., 2]
    tg = (ground_z - o[..., 2]) / dz
    hx = torch.clamp(torch.nan_to_num(o[..., 0] + tg * d[..., 0]), -1e6, 1e6)
    hy = torch.clamp(torch.nan_to_num(o[..., 1] + tg * d[..., 1]), -1e6, 1e6)
    tg = (ground_z + ground_height(hx, hy) - o[..., 2]) / dz
    ok = (dz < -1e-9) & (tg > 0.05)
    return torch.where(ok, tg, torch.inf)


def _box_frame(v: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """World vectors ``(..., 3)`` in the frame of boxes turned by their yaw."""
    return cos * v[..., 0] + sin * v[..., 1], -sin * v[..., 0] + cos * v[..., 1], v[..., 2]


def box_hits(t_best: torch.Tensor, o: torch.Tensor, d: torch.Tensor, Rc: torch.Tensor, el: torch.Tensor,
             world: dict, max_range: float) -> None:
    """Lower ``t_best`` ``(S, H, W)`` to the nearest box hit of each ray.
    ``o`` ``(S, W, 3)`` column origins, ``d`` ``(S, H, W, 3)`` directions,
    ``Rc`` ``(S, W, 3, 3)`` column rotations, ``el`` ``(H,)`` elevations."""
    S, H, W = t_best.shape
    c, half, cy, sy = world["centers"], world["half"], world["cos"], world["sin"]
    radius = torch.linalg.norm(half, dim=-1)
    step = float(el[1] - el[0])
    el0 = float(el[0])
    az = torch.arange(W, dtype=o.dtype, device=o.device) * (2 * math.pi / W) - math.pi
    zero = torch.zeros_like(az)
    n_s = torch.stack([torch.sin(az), -torch.cos(az), zero], -1)  # each column plane's normal, sensor frame
    u_s = torch.stack([torch.cos(az), torch.sin(az), zero], -1)  # its forward axis
    flat = t_best.view(-1)
    for s0 in range(0, S, SCANS_PER_CULL):
        sl = slice(s0, min(S, s0 + SCANS_PER_CULL))
        R = Rc[sl]
        n = (R @ n_s[None, :, :, None])[..., 0]
        u = (R @ u_s[None, :, :, None])[..., 0]
        zs = R[..., :, 2]
        rel = c[None, None] - o[sl, :, None]  # (s, W, M, 3)
        dn = (rel * n[:, :, None]).sum(-1)
        a = (rel * u[:, :, None]).sum(-1)
        b = (rel * zs[:, :, None]).sum(-1)
        keep = (dn.abs() <= radius) & (a >= -radius) & (torch.linalg.norm(rel, dim=-1) - radius <= max_range)
        si, wi, bi = keep.nonzero(as_tuple=True)
        if si.numel() == 0:
            continue
        a, b, dn = a[si, wi, bi], b[si, wi, bi], dn[si, wi, bi]
        r_in = torch.sqrt(torch.clamp(radius[bi] ** 2 - dn ** 2, min=0.0))
        rho = torch.sqrt(a * a + b * b)
        el_c = torch.atan2(b, a)
        delta = torch.asin(torch.clamp(r_in / torch.clamp(rho, min=1e-12), max=1.0))
        inside = rho <= r_in
        lo = torch.where(inside, 0, torch.floor((el_c - delta - el0) / step) - 1).clamp(0, H - 1).long()
        hi = torch.where(inside, H - 1, torch.ceil((el_c + delta - el0) / step) + 1).clamp(0, H - 1).long()
        count = torch.where(hi >= lo, hi - lo + 1, 0)
        si = si + s0
        ends = torch.cumsum(count, 0)
        total = int(ends[-1])
        bounds = torch.searchsorted(ends, torch.arange(TESTS_PER_CHUNK, total + TESTS_PER_CHUNK, TESTS_PER_CHUNK,
                                                       device=ends.device), right=True).tolist()
        p0 = 0
        for p1 in bounds:
            p1 = min(p1, count.numel())
            if p1 <= p0:
                continue
            cnt = count[p0:p1]
            pair = torch.repeat_interleave(torch.arange(p0, p1, device=cnt.device), cnt)
            first = torch.cumsum(cnt, 0) - cnt
            ring = lo[pair] + torch.arange(pair.numel(), device=cnt.device) - first[pair - p0]
            ps, pw, pb = si[pair], wi[pair], bi[pair]
            cosb, sinb = cy[pb], sy[pb]
            ob = _box_frame(o[ps, pw] - c[pb], cosb, sinb)
            db = _box_frame(d[ps, ring, pw], cosb, sinb)
            tmin = tmax = None
            for ax in range(3):
                inv = 1.0 / db[ax]
                t0 = (-half[pb, ax] - ob[ax]) * inv
                t1 = (half[pb, ax] - ob[ax]) * inv
                lo_ax, hi_ax = torch.minimum(t0, t1), torch.maximum(t0, t1)
                tmin = lo_ax if tmin is None else torch.maximum(tmin, lo_ax)
                tmax = hi_ax if tmax is None else torch.minimum(tmax, hi_ax)
            hit = (tmax >= tmin) & (tmax > 0) & (tmin > 0.05)
            idx = ((ps * H + ring) * W + pw)[hit]
            flat.scatter_reduce_(0, idx, tmin[hit], reduce="amin")
            p0 = p1


def world_tensors(world, device) -> dict:
    f64 = torch.float64
    yaw = torch.as_tensor(world.yaw, dtype=f64, device=device)
    return dict(centers=torch.as_tensor(world.centers, dtype=f64, device=device),
                half=torch.as_tensor(world.half, dtype=f64, device=device),
                cos=torch.cos(yaw), sin=torch.sin(yaw), ground_z=float(world.ground_z))


def cast(world: dict, R, t, twist, sensor: dict, grid, noise: List[torch.Generator] = None) -> Tuple[torch.Tensor, ...]:
    """Scans from mid-scan poses ``R`` ``(S, 3, 3)``, ``t`` ``(S, 3)`` and
    twists ``(S, 6)`` (float64 on the device): ``(xyz (S, H*W, 3) f32,
    time (S, H*W) f32, ring (S, H*W) i32, valid (S, H*W) bool)`` in the
    simulator's ray order (ring-major), xyz in the sensor frame at each
    column's own time.  ``noise`` holds one generator a scan; without it the
    ranges are exact."""
    dirs, el, col_time = grid
    H, W = dirs.shape[:2]
    S = R.shape[0]
    Rc, tc = column_poses(R, t, twist, col_time)
    d = torch.einsum("swab,hwb->shwa", Rc, dirs)  # (S, H, W, 3)
    t_best = ground_hits(tc[:, None].expand(S, H, W, 3), d, world["ground_z"]).contiguous()
    box_hits(t_best, tc, d, Rc, el, world, sensor["max_range_m"])
    t_best = torch.where(t_best <= sensor["max_range_m"], t_best, torch.inf)
    valid = torch.isfinite(t_best)
    rng = torch.where(valid, t_best, 0.0)
    if noise is not None:
        rng = rng + torch.stack([torch.randn((H, W), generator=g, dtype=rng.dtype, device=rng.device)
                                 for g in noise]) * sensor["noise_m"]
    xyz = (dirs[None] * rng[..., None]).to(torch.float32).view(S, H * W, 3)
    time = col_time.to(torch.float32)[None, None].expand(S, H, W).reshape(S, H * W)
    ring = torch.arange(H, dtype=torch.int32, device=R.device)[None, :, None].expand(S, H, W).reshape(S, H * W)
    return xyz, time, ring, valid.view(S, H * W)


def compact(xyz, time, ring, valid) -> Tuple[torch.Tensor, ...]:
    """Each scan's valid points first, in ray order (what ``xyz[valid]``
    gives), zeros after them."""
    order = torch.sort((~valid).to(torch.int8), dim=1, stable=True).indices
    v = torch.gather(valid, 1, order)
    xyz = torch.where(v[..., None], torch.gather(xyz, 1, order[..., None].expand_as(xyz)), 0.0)
    time = torch.where(v, torch.gather(time, 1, order), 0.0)
    ring = torch.where(v, torch.gather(ring, 1, order), 0)
    return xyz, time, ring, v


def fleet_scans(world, trajs: List, sensor: dict, noise_seeds: List[int], device
                ) -> Tuple[List[Tuple[torch.Tensor, ...]], int]:
    """Every frame of every instance, frame by frame: a list over frames of
    compacted ``(xyz (B, H*W, 3), time, ring, valid)``, and the largest
    number of valid points in any scan.  Instance ``i``'s noise comes from
    ``noise_seeds[i]``."""
    wt = world_tensors(world, device)
    grid = sensor_grid(sensor, device)
    gens = []
    for s in noise_seeds:
        gens.append(torch.Generator(device=device))
        gens[-1].manual_seed(int(s) % (1 << 63))
    f64 = torch.float64
    R = torch.as_tensor(np.stack([tr.R for tr in trajs]), dtype=f64, device=device)  # (B, F, 3, 3)
    t = torch.as_tensor(np.stack([tr.t for tr in trajs]), dtype=f64, device=device)
    tw = torch.as_tensor(np.stack([tr.twists for tr in trajs]), dtype=f64, device=device)
    frames, most = [], 0
    for k in range(R.shape[1]):
        sc = compact(*cast(wt, R[:, k], t[:, k], tw[:, k], sensor, grid, gens))
        most = max(most, int(sc[3].sum(1).max()))
        frames.append(sc)
    return frames, most
