"""Kernel B3: the whole ICP align loop of one fleet instance in one kernel.

Port of ``mola_lidar_odometry_tpu/ops/pallas_icp.py::align_fused``
(``_make_kernel`` at :225, ``pallas_call`` at :542).  Each iteration:

  * transform the local points by the current pose and pick, per point, the
    nearest of its C cached planar candidates (first-min), paired when
    inside ``thr_tab[it]``;
  * ``gn_inner`` robust Gauss-Newton steps on those pairings: Geman-McClure
    weights, the moments of a 7x7 Gram of ``sqrt(w) * [1, tp, r]``, a 6x6
    system plus the prior's information and SE(3)-log residual, damped
    elimination without pivoting, an SE(3)-exp update;
  * stop on step convergence, on the twist hook (total correction since the
    ORIGINAL align entry beyond its bounds) or at the iteration limit.

Then the paired-ratio quality at the final pose.

The CUDA kernel (``csrc/align.cu``) runs one thread-block cluster per
instance (:func:`align_geometry` sets its shape): each CTA keeps its slice of
the points, and of the candidate planes when they fit, on chip; the moments
are reduced across the cluster through distributed shared memory so that
every CTA solves the 6x6 system on one warp and takes the same loop
decision.  It is bound by latency (a chain of barriers and small solves per
iteration), not by bytes or flops.  Reductions run in another order than the
plain twin's, so the two agree to within 3e-3 on R and t, one iteration and
0.02 quality.

:func:`align_fused` launches the kernel for CUDA tensors and runs
:func:`align_fused_plain` for CPU tensors.  Both take the candidates as
planes ``(cx, cy, cz, cm)``, each ``(B, C, npad)``: kernel B1's or B2's
output, or a ``voxel_hash.CandSet`` (``pts (B, N, C, 3)``, ``mask (B, N,
C)``) from the plain capture, which :func:`candset_planes` transposes and
pads into that layout (the JAX wrapper's :471-490).
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Tuple

import torch

from mola_lidar_odometry_tpu_torch.ops import cuda_build
from mola_lidar_odometry_tpu_torch.ops.voxel_hash import CandSet
from mola_lidar_odometry_tpu_torch.utils import profiler

BIG = 3.4e38
N_PARAMS = 74  # per instance: limit, it0, R0 t0, prior R t, hook-ref R t, info(36)


def _static_thresholds(min_abs_step_trans, min_abs_step_rot, hook_min_trans, hook_min_rot):
    """Squared translation thresholds and sin^2 rotation thresholds; a
    disabled hook leg becomes BIG (same host-side transform as JAX)."""

    def rot2(x):
        return math.sin(x) ** 2 if 0.0 <= x < math.pi / 2 else BIG

    hook_on = hook_min_trans > 0 or hook_min_rot > 0
    return (
        min_abs_step_trans**2,
        rot2(min_abs_step_rot),
        hook_min_trans**2 if hook_on else BIG,
        rot2(hook_min_rot) if hook_on else BIG,
    )


def candset_planes(cand: CandSet) -> Tuple[torch.Tensor, ...]:
    """A ``CandSet`` as kernel B3's planes ``(cx, cy, cz, cm)``, each ``(B,
    C, npad)`` f32 with ``npad`` = N rounded up to 128: one transpose and
    one pad of the four coordinates (mask as 0/1), the candidate order kept
    (the per-voxel capture's: each probe's nearest point, then each probe's
    second).  These are query-minor, not kernel B4's ``(B, N, C)`` planes."""
    B, n, C, _ = cand.pts.shape
    npad = _round_up(max(n, 128), 128)
    cand4 = torch.cat([cand.pts, cand.mask.to(torch.float32)[..., None]], dim=-1)  # (B, N, C, 4)
    planes = torch.nn.functional.pad(cand4.permute(3, 0, 2, 1), (0, npad - n)).contiguous()  # (4, B, C, npad)
    return tuple(planes.unbind(0))


def _planes(planar) -> Tuple[torch.Tensor, ...]:
    return candset_planes(planar) if isinstance(planar, CandSet) else planar


# ---------------------------------------------------------------------------
# scalar SE(3) helpers on tuples of (B,) tensors (the kernel's scalar math)
# ---------------------------------------------------------------------------


def _mat_vec(R, v):
    return (
        R[0] * v[0] + R[1] * v[1] + R[2] * v[2],
        R[3] * v[0] + R[4] * v[1] + R[5] * v[2],
        R[6] * v[0] + R[7] * v[1] + R[8] * v[2],
    )


def _transpose(R):
    return (R[0], R[3], R[6], R[1], R[4], R[7], R[2], R[5], R[8])


def _mat_mul(A, B):
    return tuple(
        A[3 * i] * B[j] + A[3 * i + 1] * B[3 + j] + A[3 * i + 2] * B[6 + j]
        for i in range(3)
        for j in range(3)
    )


def _compose(Ra, ta, Rb, tb):
    t = _mat_vec(Ra, tb)
    return _mat_mul(Ra, Rb), (t[0] + ta[0], t[1] + ta[1], t[2] + ta[2])


def _inverse(R, t):
    Rt = _transpose(R)
    ti = _mat_vec(Rt, t)
    return Rt, (-ti[0], -ti[1], -ti[2])


def _sinc_coeffs(t2):
    """A=sin/t, B=(1-cos)/t^2, C=(1-A)/t^2 as the kernel's Taylor polynomials."""
    t4 = t2 * t2
    t6 = t4 * t2
    A = 1.0 - t2 / 6.0 + t4 / 120.0 - t6 / 5040.0
    B = 0.5 - t2 / 24.0 + t4 / 720.0 - t6 / 40320.0
    C = 1.0 / 6.0 - t2 / 120.0 + t4 / 5040.0 - t6 / 362880.0
    return A, B, C


def _axes_mats(w):
    x, y, z = w
    zero = x * 0.0
    K = (zero, -z, y, z, zero, -x, -y, x, zero)
    xx, yy, zz = x * x, y * y, z * z
    K2 = (-(yy + zz), x * y, x * z, x * y, -(xx + zz), y * z, x * z, y * z, -(xx + yy))
    return K, K2


_I9 = (1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0)


def _se3_exp(xi):
    rho, phi = xi[:3], xi[3:]
    A, B, C = _sinc_coeffs(phi[0] * phi[0] + phi[1] * phi[1] + phi[2] * phi[2])
    K, K2 = _axes_mats(phi)
    R = tuple(_I9[i] + A * K[i] + B * K2[i] for i in range(9))
    V = tuple(_I9[i] + B * K[i] + C * K2[i] for i in range(9))
    return R, _mat_vec(V, rho)


def _so3_log(R):
    """Axis-angle without inverse trig: theta/sin(theta) from the arcsine
    series in u = (1-cos)/2 (exact to f32 for theta <= ~1 rad)."""
    trace = R[0] + R[4] + R[8]
    u = torch.clamp((1.0 - (trace - 1.0) * 0.5) * 0.5, 0.0, 0.9999)
    wx, wy, wz = (R[7] - R[5]) * 0.5, (R[2] - R[6]) * 0.5, (R[3] - R[1]) * 0.5
    ser = 1.0 + u / 6.0 + 3.0 * u * u / 40.0 + 15.0 * u * u * u / 336.0
    scale = ser * torch.rsqrt(1.0 - u)
    return (scale * wx, scale * wy, scale * wz)


def _se3_log(R, t):
    phi = _so3_log(R)
    theta2 = phi[0] * phi[0] + phi[1] * phi[1] + phi[2] * phi[2]
    A, B, _ = _sinc_coeffs(theta2)
    K, K2 = _axes_mats(phi)
    small = theta2 < 1e-8
    safe_t2 = torch.where(small, 1.0, theta2)
    coef = torch.where(small, 1.0 / 12.0 + theta2 / 720.0, (1.0 - A / (2.0 * B)) / safe_t2)
    Vinv = tuple(_I9[i] - 0.5 * K[i] + coef * K2[i] for i in range(9))
    return _mat_vec(Vinv, t) + phi


def _sin_angle2(R):
    wx, wy, wz = (R[7] - R[5]) * 0.5, (R[2] - R[6]) * 0.5, (R[3] - R[1]) * 0.5
    return wx * wx + wy * wy + wz * wz


def _solve6(H, b, damp):
    """(H + damp*scale*I) x = b by elimination without pivoting."""
    scale = (H[0] + H[7] + H[14] + H[21] + H[28] + H[35]) / 6.0 + 1.0
    A = [[H[6 * i + j] + (damp * scale if i == j else 0.0) for j in range(6)] for i in range(6)]
    x = list(b)
    for k in range(6):
        inv = 1.0 / A[k][k]
        for i in range(k + 1, 6):
            f = A[i][k] * inv
            for j in range(k + 1, 6):
                A[i][j] = A[i][j] - f * A[k][j]
            x[i] = x[i] - f * x[k]
    for k in range(5, -1, -1):
        s = x[k]
        for j in range(k + 1, 6):
            s = s - A[k][j] * x[j]
        x[k] = s / A[k][k]
    return x


def align_fused_plain(
    planar,  # (cx, cy, cz, cm), each (B, C, npad) f32 from kernel B1/B2, or a CandSet
    pts: torch.Tensor,  # (B, N, 3) local points (sensor frame)
    valid: torch.Tensor,  # (B, N) bool
    init_R: torch.Tensor,  # (B, 3, 3)
    init_t: torch.Tensor,  # (B, 3)
    prior_R: torch.Tensor,  # (B, 3, 3)
    prior_t: torch.Tensor,  # (B, 3)
    prior_info: torch.Tensor,  # (B, 6, 6)
    thr_tab: torch.Tensor,  # (B, maxit) matcher threshold per iteration
    kc_tab: torch.Tensor,  # (B, maxit) robust kernel parameter per iteration
    budget: torch.Tensor,  # (B,) i32 remaining iteration budget
    *,
    min_abs_step_trans: float,
    min_abs_step_rot: float,
    hook_min_trans: float,
    hook_min_rot: float,
    weight: float = 1.0,
    damping: float = 1e-8,
    gn_inner: int = 2,
    it0: torch.Tensor = None,  # (B,) i32 — resume iteration index
    hook_ref_R: torch.Tensor = None,  # original align-entry pose for the hook
    hook_ref_t: torch.Tensor = None,
) -> Tuple[torch.Tensor, ...]:
    """Plain twin of kernel B3.  Returns ``(R, t, iters, hook, converged,
    quality)``; ``iters`` counts from ``it0``.  Instances iterate in lock
    step, each frozen once it stops, as the JAX kernel does under ``vmap``."""
    cx, cy, cz, cm = _planes(planar)
    B, C, npad = cx.shape
    n = pts.shape[1]
    dev = pts.device
    if it0 is None:
        it0 = torch.zeros((B,), dtype=torch.int32, device=dev)
    if hook_ref_R is None:
        hook_ref_R, hook_ref_t = init_R, init_t
    min_t, min_r, hook_t, hook_r = _static_thresholds(
        min_abs_step_trans, min_abs_step_rot, hook_min_trans, hook_min_rot
    )
    maxit = thr_tab.shape[1]
    thr2_tab = thr_tab * thr_tab
    limit = it0 + budget

    def pad(x):
        return torch.nn.functional.pad(x, (0, npad - n))

    px, py, pz = (pad(pts[..., a]) for a in range(3))
    pvalid = pad(valid.to(torch.float32))
    n_valid = torch.sum(pvalid, dim=-1)
    cmask = cm > 0
    lane_c = torch.arange(C, device=dev).view(1, C, 1)

    def flat9(M):
        return tuple(M[:, i // 3, i % 3] for i in range(9))

    Rp, tpr = flat9(prior_R), tuple(prior_t.unbind(-1))
    Rh, th = flat9(hook_ref_R), tuple(hook_ref_t.unbind(-1))
    info = tuple(prior_info[:, i // 6, i % 6] for i in range(36))
    info_trace = info[0] + info[7] + info[14] + info[21] + info[28] + info[35]

    def col(x):
        return x[:, None]

    def match(R, t, thr2):
        qx = col(R[0]) * px + col(R[1]) * py + col(R[2]) * pz + col(t[0])
        qy = col(R[3]) * px + col(R[4]) * py + col(R[5]) * pz + col(t[1])
        qz = col(R[6]) * px + col(R[7]) * py + col(R[8]) * pz + col(t[2])
        dx, dy, dz = cx - qx[:, None], cy - qy[:, None], cz - qz[:, None]
        d2 = torch.where(cmask, dx * dx + dy * dy + dz * dz, BIG)
        dmin = torch.amin(d2, dim=1, keepdim=True)
        first = torch.amin(torch.where(d2 <= dmin, lane_c, C), dim=1, keepdim=True)
        tx, ty, tz = (torch.gather(c, 1, first)[:, 0] for c in (cx, cy, cz))
        dmin = dmin[:, 0]
        pair = pvalid * (dmin < col(thr2)).to(torch.float32) * (dmin < BIG).to(torch.float32)
        return tx, ty, tz, pair, torch.sum(pair, dim=-1)

    Ri, ti = _inverse(Rp, tpr)

    def gn_step(R, t, tx, ty, tz, pair, kc, any_pair):
        tpx = col(R[0]) * px + col(R[1]) * py + col(R[2]) * pz + col(t[0])
        tpy = col(R[3]) * px + col(R[4]) * py + col(R[5]) * pz + col(t[1])
        tpz = col(R[6]) * px + col(R[7]) * py + col(R[8]) * pz + col(t[2])
        rx, ry, rz = tpx - tx, tpy - ty, tpz - tz
        r2 = rx * rx + ry * ry + rz * rz
        c2 = col(kc * kc)
        gm = c2 / (r2 + c2)
        sw = torch.sqrt(gm * gm * pair * weight)
        m = (sw, sw * tpx, sw * tpy, sw * tpz, sw * rx, sw * ry, sw * rz)

        def G(i, j):
            return torch.sum(m[i] * m[j], dim=-1)

        S, Sx, Sy, Sz = G(0, 0), G(0, 1), G(0, 2), G(0, 3)
        Sxx, Syy, Szz = G(1, 1), G(2, 2), G(3, 3)
        Sxy, Sxz, Syz = G(1, 2), G(1, 3), G(2, 3)
        b = [G(0, 4), G(0, 5), G(0, 6), G(2, 6) - G(3, 5), G(3, 4) - G(1, 6), G(1, 5) - G(2, 4)]
        zero = S * 0.0
        SK = (zero, -Sz, Sy, Sz, zero, -Sx, -Sy, Sx, zero)
        trS = Sxx + Syy + Szz
        KtK = (trS - Sxx, -Sxy, -Sxz, -Sxy, trS - Syy, -Syz, -Sxz, -Syz, trS - Szz)
        H = [zero] * 36
        for i in range(3):
            H[6 * i + i] = S
            for j in range(3):
                H[6 * i + 3 + j] = -SK[3 * i + j]
                H[6 * (3 + i) + j] = SK[3 * i + j]
                H[6 * (3 + i) + 3 + j] = KtK[3 * i + j]
        Rrel, trel = _compose(Ri, ti, R, t)
        rp = _se3_log(Rrel, trel)
        for i in range(6):
            for j in range(6):
                H[6 * i + j] = H[6 * i + j] + info[6 * i + j]
                b[i] = b[i] + info[6 * i + j] * rp[j]
        eps = _solve6(H, b, damping)
        ok = (any_pair > 0) | (info_trace > 0)
        Re, te = _se3_exp(tuple(torch.where(ok, -e, 0.0) for e in eps))
        return _compose(Re, te, R, t)

    R, t = flat9(init_R), tuple(init_t.unbind(-1))
    it = it0.clone()
    conv = torch.zeros((B,), dtype=torch.bool, device=dev)
    hook = torch.zeros_like(conv)
    while True:
        active = ~conv & ~hook & (it < limit)
        if not bool(active.any()):
            break
        sel = torch.clamp(it, max=maxit - 1).long()[:, None]
        thr2 = torch.gather(thr2_tab, 1, sel)[:, 0]
        kc = torch.gather(kc_tab, 1, sel)[:, 0]
        tx, ty, tz, pair, npair = match(R, t, thr2)
        Rn, tn = R, t
        for _ in range(gn_inner):
            Rn, tn = gn_step(Rn, tn, tx, ty, tz, pair, kc, npair)
        dRt = _mat_mul(_transpose(R), Rn)
        dt2 = (tn[0] - t[0]) ** 2 + (tn[1] - t[1]) ** 2 + (tn[2] - t[2]) ** 2
        conv_n = (dt2 < min_t) & (_sin_angle2(dRt) < min_r)
        hRt = _mat_mul(_transpose(Rh), Rn)
        ht2 = (tn[0] - th[0]) ** 2 + (tn[1] - th[1]) ** 2 + (tn[2] - th[2]) ** 2
        hook_n = (ht2 > hook_t) | (_sin_angle2(hRt) > hook_r)
        R = tuple(torch.where(active, a, b) for a, b in zip(Rn, R))
        t = tuple(torch.where(active, a, b) for a, b in zip(tn, t))
        it = torch.where(active, it + 1, it)
        conv = torch.where(active, conv_n, conv)
        hook = torch.where(active, hook_n, hook)

    sel = torch.clamp(it, max=maxit - 1).long()[:, None]
    *_, npair_q = match(R, t, torch.gather(thr2_tab, 1, sel)[:, 0])
    quality = npair_q / torch.clamp(n_valid, min=1.0)
    return (
        torch.stack(R, dim=-1).view(B, 3, 3),
        torch.stack(t, dim=-1),
        (it - it0).to(torch.int32),
        hook,
        conv,
        quality,
    )


# ---------------------------------------------------------------------------
# the CUDA kernel (csrc/align.cu)
# ---------------------------------------------------------------------------


# CTAs per instance.  16 (a non-portable cluster size) beat 8 on an H100 at
# B=8 and tied at B=16 (PERF.md).
CLUSTER = 16
MAX_THREADS = 512  # csrc/align.cu kMaxThreads
PPTS = (1, 2)  # the kernel's instantiations of points per thread
MAX_NPAD = CLUSTER * MAX_THREADS * PPTS[-1]  # 16384, the fused path's largest N (ops/icp.py)
SMEM_PLANES_MAX = 232448 - 4096  # the opt-in shared memory of a CTA, less its static part


class AlignGeometry(NamedTuple):
    cluster: int  # CTAs per instance (one cluster each)
    slice: int  # points per CTA
    threads: int  # threads per CTA
    ppt: int  # points per thread
    smem_bytes: int  # dynamic shared memory per CTA
    planes_in_smem: bool  # the slice's planes in shared memory, else read from global memory


def align_geometry(npad: int, C: int) -> AlignGeometry:
    """Launch shape of kernel B3 for ``npad`` points and ``C`` candidates.

    The slice's four candidate planes (``16 * C * slice`` bytes) live in
    shared memory when they fit and are read from global memory on every
    pass otherwise; that branch follows from the shape alone."""
    if npad % 128:
        raise ValueError(f"align kernel: npad={npad} must be a multiple of 128")
    if npad > MAX_NPAD:
        raise ValueError(f"align kernel: npad={npad} > {MAX_NPAD} points")
    sl = npad // CLUSTER
    ppt = next(p for p in PPTS if p * MAX_THREADS >= sl)
    threads = _round_up(-(-sl // ppt), 32)
    planes = 16 * C * sl
    fits = planes <= SMEM_PLANES_MAX
    return AlignGeometry(CLUSTER, sl, threads, ppt, planes if fits else 0, fits)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def align_fused(
    planar, pts, valid, init_R, init_t, prior_R, prior_t, prior_info, thr_tab, kc_tab, budget, *,
    min_abs_step_trans: float, min_abs_step_rot: float, hook_min_trans: float, hook_min_rot: float,
    weight: float = 1.0, damping: float = 1e-8, gn_inner: int = 2, it0=None, hook_ref_R=None,
    hook_ref_t=None,
):
    """Kernel B3 (see :func:`align_fused_plain` for the contract).  On the
    card each launch adds its waves (:func:`max_active_clusters`) to the
    active profiler's ``b3.waves`` counter when that profiler is enabled."""
    planar = _planes(planar)
    kw = dict(
        min_abs_step_trans=min_abs_step_trans, min_abs_step_rot=min_abs_step_rot,
        hook_min_trans=hook_min_trans, hook_min_rot=hook_min_rot, weight=weight,
        damping=damping, gn_inner=gn_inner, it0=it0, hook_ref_R=hook_ref_R, hook_ref_t=hook_ref_t,
    )
    args = (planar, pts, valid, init_R, init_t, prior_R, prior_t, prior_info, thr_tab, kc_tab, budget)
    if not pts.is_cuda:
        return align_fused_plain(*args, **kw)
    cx = planar[0]
    geo = align_geometry(cx.shape[2], cx.shape[1])
    launch, result = align_launcher(geo, *args, **kw)
    launch()
    align_fused.launches += 1
    prof = profiler.active()
    if prof.enabled:
        prof.add("b3.waves", -(-cx.shape[0] // max_active_clusters(geo, pts.device)))
    return result()


_clusters = {}  # (geometry, device) -> max_active_clusters


def max_active_clusters(geo: AlignGeometry, device) -> int:
    """Clusters of shape ``geo`` that ``device`` runs at once
    (``cudaOccupancyMaxActiveClusters``, asked once per shape and card): a
    launch of B instances runs in ceil(B / this) waves."""
    key = (geo, str(device))
    if key not in _clusters:
        fn = cuda_build.load("align").align_max_active_clusters
        fn.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
        n = ctypes.c_int(0)
        with torch.cuda.device(device):
            cuda_build.check(fn(geo.cluster, geo.threads, geo.ppt, geo.smem_bytes, ctypes.byref(n)),
                             "align_max_active_clusters")
        _clusters[key] = n.value
    return _clusters[key]


def align_launcher(
    geo: AlignGeometry, planar, pts, valid, init_R, init_t, prior_R, prior_t,
    prior_info, thr_tab, kc_tab, budget, *, min_abs_step_trans, min_abs_step_rot, hook_min_trans,
    hook_min_rot, weight=1.0, damping=1e-8, gn_inner=2, it0=None, hook_ref_R=None, hook_ref_t=None,
):
    """Check the inputs and pack the kernel's arguments once; returns
    ``(launch, result)``: ``launch()`` runs ``align_kernel`` with shape
    ``geo`` on the current stream (it raises on a refused launch), and
    ``result()`` reads the outputs of the last launch.  The split lets a
    measurement time the kernel without the packing."""
    planar = _planes(planar)
    cx, cy, cz, cm = planar
    B, C, npad = cx.shape
    n = pts.shape[1]
    dev = pts.device
    for name, x in (("cx", cx), ("cy", cy), ("cz", cz), ("cm", cm), ("pts", pts)):
        if x.device != dev or x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"align kernel: {name} must be contiguous float32 on {dev}")
    if cm.shape != cx.shape or cy.shape != cx.shape or cz.shape != cx.shape:
        raise ValueError("align kernel: candidate planes differ in shape")
    if pts.shape != (B, n, 3) or valid.shape != (B, n) or npad < n or npad % 128:
        raise ValueError(f"align kernel: pts {tuple(pts.shape)} vs candidates {tuple(cx.shape)}")
    if thr_tab.shape != kc_tab.shape or thr_tab.shape[0] != B:
        raise ValueError("align kernel: thr_tab/kc_tab must be (B, maxit)")
    if it0 is None:
        it0 = torch.zeros((B,), dtype=torch.int32, device=dev)
    if hook_ref_R is None:
        hook_ref_R, hook_ref_t = init_R, init_t
    min_t, min_r, hook_t, hook_r = _static_thresholds(
        min_abs_step_trans, min_abs_step_rot, hook_min_trans, hook_min_rot
    )
    f32 = torch.float32
    params = torch.cat(
        [
            (it0 + budget).to(f32)[:, None], it0.to(f32)[:, None],
            init_R.reshape(B, 9).to(f32), init_t.to(f32), prior_R.reshape(B, 9).to(f32),
            prior_t.to(f32), hook_ref_R.reshape(B, 9).to(f32), hook_ref_t.to(f32),
            prior_info.reshape(B, 36).to(f32),
        ],
        dim=1,
    ).contiguous()
    thr2 = (thr_tab * thr_tab).to(f32).contiguous()
    kc = kc_tab.to(f32).contiguous()
    valid_u8 = valid.to(torch.uint8).contiguous()
    out = torch.empty((B, 16), dtype=f32, device=dev)
    fn = cuda_build.load("align").align_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 12 + [ctypes.c_float] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    p = cuda_build.ptr
    argv = (
        p(pts), p(valid_u8), p(cx), p(cy), p(cz), p(cm), p(params), p(thr2), p(kc), p(out),
        B, n, npad, C, thr_tab.shape[1], gn_inner, geo.cluster, geo.threads, geo.ppt, geo.slice,
        int(geo.planes_in_smem), geo.smem_bytes, min_t, min_r, hook_t, hook_r, damping, weight,
    )

    def launch():
        cuda_build.launch(fn, argv, dev, "align_kernel")

    launch.tensors = (pts, valid_u8, planar, params, thr2, kc, out)  # alive as long as launch

    def result():
        R = out[:, :9].reshape(B, 3, 3)
        iters = out[:, 12].to(torch.int32) - it0.to(torch.int32)
        return R, out[:, 9:12], iters, out[:, 13] > 0, out[:, 14] > 0, out[:, 15]

    return launch, result


align_fused.launches = 0
