// Kernel B3: the whole ICP align loop of one fleet instance.
//
// Replaces mola_lidar_odometry_tpu/ops/pallas_icp.py::align_fused
// (_make_kernel(C, npad, gn_inner, maxit) at :225, pallas_call at :542).
//
// What bounds it on Hopper: latency, not bytes or flops.  An instance is a
// data-dependent chain of ~10 iterations, each of gn_inner passes over the
// npad points whose 19 Gram moments feed a 6x6 solve that the next pass
// needs.  The byte bound (inputs read once) is a few microseconds; the chain
// of reductions, cluster barriers and small solves is what takes the time:
// about 3.5 us per pass on an H100, of which the barrier and the solve alone
// are about 2 us (the clock64 split of a pass in PERF.md).
//
// Design:
//   * One thread-block cluster of cs CTAs per instance (cs = 16, a
//     non-portable size that measured faster than 8): 128 CTAs at B=8 where
//     one block per instance used 8 of the 132 SMs.  CTA r owns the
//     contiguous slice [r*slice, (r+1)*slice) of the npad points, PPT points
//     per thread: 1 at the bench shape, 2 up to npad = 16384, the largest
//     that the fused path takes (ops/icp.py).
//   * What the loop re-reads is loaded once: the CTA's slice of the four
//     candidate planes (C x slice x 16 B, 48 KB at npad=3072, C=16) is
//     copied to shared memory with 16-byte cp.async; the points, their valid
//     bits and each point's target and pair flag stay in registers across
//     the gn_inner passes (no scratch tensor).  When the slice's planes do
//     not fit in shared memory, the same code reads them from global memory
//     (L2) on every pass: the wrapper picks that branch from the shape.
//   * Each pass reduces the 20 values (19 moments + pair count) per warp
//     with a transposed butterfly (31 shuffles, lane k ends up owning value
//     k), then across the CTA's warps in warp order; the CTA's 20 sums are
//     stored into slot [rank] of EVERY CTA of the cluster (distributed shared
//     memory, map_shared_rank; the stores are spread over the warps).  After
//     one cluster barrier each CTA sums the cs slots it holds, in rank order,
//     from its own shared memory: every CTA holds bit-identical sums, solves
//     redundantly and reaches the same pose and the same loop decision
//     without a broadcast, and no remote read sits on the critical path.  The
//     slots are double-buffered, so one barrier per pass suffices: a CTA
//     writes buffer k%2 again only in pass k+2, after every CTA has passed
//     barrier k+1 and so finished reading pass k.  A decision that differed
//     between CTAs would deadlock the cluster; every decision (the loop exit,
//     the initial valid count, the final quality) therefore comes from the
//     reduced values and the poses derived from them only.
//   * The serial tail runs on warp 0: the prior's SE(3)-log residual is
//     computed between the arrive and the wait of the cluster barrier (it
//     depends on the pose only); lane i < 6 holds row i of [H | b] and the
//     damped no-pivot elimination runs row-parallel in the order of the
//     serial solve (forward elimination k = 0..5, then back substitution
//     k = 5..0), each row k broadcast by shuffles; the SE(3) exp and compose
//     follow.  Every helper is inlined and the rows are chosen by selects, so
//     the chain has no divergent branch and no local memory.
//
// Numbers: the moments are summed in another order than the plain twin's
// (per thread, butterfly, warps, cluster ranks), the back substitution
// multiplies by each pivot's reciprocal and the exp/log series multiply by
// their constants' reciprocals, so kernel and twin differ in the last bits
// and agree within 3e-3 on R and t, one iteration and 0.02 quality, not bit
// for bit.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr float kBig = 3.4e38f;
constexpr int kMaxThreads = 512;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMom = 20;  // 19 moments + pair count
constexpr int kMaxCluster = 16;
constexpr int kParams = 74;
constexpr unsigned kFull = 0xffffffffu;

struct Pose { float R[9]; float t[3]; };

__device__ __forceinline__ void mat_mul(const float* A, const float* B, float* out) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      out[3 * i + j] = A[3 * i] * B[j] + A[3 * i + 1] * B[3 + j] + A[3 * i + 2] * B[6 + j];
}

__device__ __forceinline__ void mat_vec(const float* R, const float* v, float* out) {
  for (int i = 0; i < 3; ++i) out[i] = R[3 * i] * v[0] + R[3 * i + 1] * v[1] + R[3 * i + 2] * v[2];
}

__device__ __forceinline__ void transpose(const float* R, float* out) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) out[3 * i + j] = R[3 * j + i];
}

__device__ __forceinline__ Pose compose(const Pose& a, const Pose& b) {
  Pose o;
  mat_mul(a.R, b.R, o.R);
  mat_vec(a.R, b.t, o.t);
  for (int i = 0; i < 3; ++i) o.t[i] += a.t[i];
  return o;
}

__device__ __forceinline__ Pose inverse(const Pose& p) {
  Pose o;
  transpose(p.R, o.R);
  mat_vec(o.R, p.t, o.t);
  for (int i = 0; i < 3; ++i) o.t[i] = -o.t[i];
  return o;
}

// (the series' divisions by constants as products with their reciprocals:
// the same terms to within one rounding, off the solve's serial chain)
__device__ __forceinline__ void sinc_coeffs(float t2, float& A, float& B, float& C) {
  const float t4 = t2 * t2, t6 = t4 * t2;
  A = 1.0f - t2 * (1.0f / 6.0f) + t4 * (1.0f / 120.0f) - t6 * (1.0f / 5040.0f);
  B = 0.5f - t2 * (1.0f / 24.0f) + t4 * (1.0f / 720.0f) - t6 * (1.0f / 40320.0f);
  C = 1.0f / 6.0f - t2 * (1.0f / 120.0f) + t4 * (1.0f / 5040.0f) - t6 * (1.0f / 362880.0f);
}

__device__ __forceinline__ void axes_mats(const float* w, float* K, float* K2) {
  const float x = w[0], y = w[1], z = w[2];
  K[0] = 0.f; K[1] = -z; K[2] = y; K[3] = z; K[4] = 0.f; K[5] = -x; K[6] = -y; K[7] = x; K[8] = 0.f;
  const float xx = x * x, yy = y * y, zz = z * z;
  K2[0] = -(yy + zz); K2[1] = x * y; K2[2] = x * z;
  K2[3] = x * y; K2[4] = -(xx + zz); K2[5] = y * z;
  K2[6] = x * z; K2[7] = y * z; K2[8] = -(xx + yy);
}

__device__ __forceinline__ Pose se3_exp(const float* xi) {
  const float* phi = xi + 3;
  float A, B, C, K[9], K2[9], V[9];
  sinc_coeffs(phi[0] * phi[0] + phi[1] * phi[1] + phi[2] * phi[2], A, B, C);
  axes_mats(phi, K, K2);
  Pose o;
  for (int i = 0; i < 9; ++i) {
    const float I = (i % 4 == 0) ? 1.f : 0.f;
    o.R[i] = I + A * K[i] + B * K2[i];
    V[i] = I + B * K[i] + C * K2[i];
  }
  mat_vec(V, xi, o.t);
  return o;
}

__device__ __forceinline__ void se3_log(const Pose& p, float* xi) {
  const float* R = p.R;
  const float trace = R[0] + R[4] + R[8];
  const float u = fminf(fmaxf((1.0f - (trace - 1.0f) * 0.5f) * 0.5f, 0.0f), 0.9999f);
  const float ser = 1.0f + u / 6.0f + 3.0f * u * u / 40.0f + 15.0f * u * u * u / 336.0f;
  const float scale = ser / sqrtf(1.0f - u);
  float phi[3] = {scale * (R[7] - R[5]) * 0.5f, scale * (R[2] - R[6]) * 0.5f,
                  scale * (R[3] - R[1]) * 0.5f};
  const float theta2 = phi[0] * phi[0] + phi[1] * phi[1] + phi[2] * phi[2];
  float A, B, C, K[9], K2[9], Vinv[9];
  sinc_coeffs(theta2, A, B, C);
  axes_mats(phi, K, K2);
  const bool small = theta2 < 1e-8f;
  const float coef = small ? 1.0f / 12.0f + theta2 / 720.0f : (1.0f - A / (2.0f * B)) / theta2;
  for (int i = 0; i < 9; ++i) Vinv[i] = ((i % 4 == 0) ? 1.f : 0.f) - 0.5f * K[i] + coef * K2[i];
  mat_vec(Vinv, p.t, xi);
  for (int i = 0; i < 3; ++i) xi[3 + i] = phi[i];
}

__device__ __forceinline__ float sin_angle2(const float* R) {
  const float wx = (R[7] - R[5]) * 0.5f, wy = (R[2] - R[6]) * 0.5f, wz = (R[3] - R[1]) * 0.5f;
  return wx * wx + wy * wy + wz * wz;
}

// ---------------------------------------------------------------------------
// cluster barrier, split so that warp 0 can work between arrive and wait
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Transposed warp reduction of kMom values (padded to 32): after the five
// exchange steps lane k holds the warp's sum of value k.
__device__ __forceinline__ float warp_reduce_transposed(const float* v, int lane) {
  float a[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const float lo = v[k], hi = (k + 16 < kMom) ? v[k + 16] : 0.f;
    const bool up = lane & 16;
    a[k] = (up ? hi : lo) + __shfl_xor_sync(kFull, up ? lo : hi, 16);
  }
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) {
#pragma unroll
    for (int k = 0; k < o; ++k) {
      const bool up = lane & o;
      a[k] = (up ? a[k + o] : a[k]) + __shfl_xor_sync(kFull, up ? a[k] : a[k + o], o);
    }
  }
  return a[0];
}

// Accumulate the moments of one point (sqrt-weighted rows, as the JAX Gram).
__device__ __forceinline__ void add_moments(float* v, float tpx, float tpy, float tpz, float tx,
                                            float ty, float tz, float pair, float kc, float weight) {
  const float rx = tpx - tx, ry = tpy - ty, rz = tpz - tz;
  const float r2 = rx * rx + ry * ry + rz * rz;
  const float c2 = kc * kc;
  const float gm = c2 / (r2 + c2);
  const float sw = sqrtf(gm * gm * pair * weight);
  const float m0 = sw, m1 = sw * tpx, m2 = sw * tpy, m3 = sw * tpz;
  const float m4 = sw * rx, m5 = sw * ry, m6 = sw * rz;
  v[0] += m0 * m0; v[1] += m0 * m1; v[2] += m0 * m2; v[3] += m0 * m3;
  v[4] += m1 * m1; v[5] += m2 * m2; v[6] += m3 * m3;
  v[7] += m1 * m2; v[8] += m1 * m3; v[9] += m2 * m3;
  v[10] += m0 * m4; v[11] += m0 * m5; v[12] += m0 * m6;
  v[13] += m2 * m6; v[14] += m3 * m5;
  v[15] += m3 * m4; v[16] += m1 * m6;
  v[17] += m1 * m5; v[18] += m2 * m4;
}

// One robust Gauss-Newton update of `pose` on warp 0: m = the reduced moments
// (m[19] the pair count of the iteration's match pass), rp = the prior's
// SE(3)-log residual at `pose`, info_row = row `lane` of the prior's
// information (lanes 0..5).  Every lane builds [H | b] (independent
// operations), lane i < 6 keeps row i by selects (no divergent branches), the
// elimination runs row-parallel with row k broadcast by shuffles, and every
// lane returns the same pose.  Each pivot's reciprocal is taken once (one
// IEEE division per row) and reused by the back substitution.
__device__ __forceinline__ Pose gn_update_warp(const Pose& pose, const float* m, const float* rp,
                                               const float* info_row, float info_trace, float damp,
                                               int lane) {
  const float S = m[0], Sx = m[1], Sy = m[2], Sz = m[3];
  const float Sxx = m[4], Syy = m[5], Szz = m[6], Sxy = m[7], Sxz = m[8], Syz = m[9];
  const float SK[9] = {0.f, -Sz, Sy, Sz, 0.f, -Sx, -Sy, Sx, 0.f};
  const float trS = Sxx + Syy + Szz;
  const float KtK[9] = {trS - Sxx, -Sxy, -Sxz, -Sxy, trS - Syy, -Syz, -Sxz, -Syz, trS - Szz};
  float H[6][7];  // [H | b] without the prior
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      H[i][j] = (i == j) ? S : 0.f;
      H[i][3 + j] = -SK[3 * i + j];
      H[3 + i][j] = SK[3 * i + j];
      H[3 + i][3 + j] = KtK[3 * i + j];
    }
  }
  H[0][6] = m[10]; H[1][6] = m[11]; H[2][6] = m[12];
  H[3][6] = m[13] - m[14];  // G26 - G35
  H[4][6] = m[15] - m[16];  // G34 - G16
  H[5][6] = m[17] - m[18];  // G15 - G24
  float a[7];
#pragma unroll
  for (int j = 0; j < 7; ++j) {
    float x = H[0][j];
#pragma unroll
    for (int r = 1; r < 6; ++r) x = (lane == r) ? H[r][j] : x;
    a[j] = x;
  }
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    a[j] += info_row[j];
    a[6] += info_row[j] * rp[j];
  }
  // damping: scale = mean of the diagonal + 1, summed in row order
  float diag = a[0];
#pragma unroll
  for (int r = 1; r < 6; ++r) diag = (lane == r) ? a[r] : diag;
  float dsum = __shfl_sync(kFull, diag, 0);
#pragma unroll
  for (int r = 1; r < 6; ++r) dsum += __shfl_sync(kFull, diag, r);
  const float ds = damp * (dsum * (1.0f / 6.0f) + 1.0f);
#pragma unroll
  for (int r = 0; r < 6; ++r) a[r] += (lane == r) ? ds : 0.f;
  // forward elimination, row k broadcast from lane k, rows below update in parallel
  float inv[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    float pk[7];
#pragma unroll
    for (int j = k; j < 7; ++j) pk[j] = __shfl_sync(kFull, a[j], k);
    inv[k] = 1.0f / pk[k];
    if (lane > k && lane < 6) {
      const float f = a[k] * inv[k];
#pragma unroll
      for (int j = k + 1; j < 7; ++j) a[j] -= f * pk[j];
    }
  }
  // back substitution: x_k on lane k, broadcast, rows above subtract it
  float x[6];
  float s = a[6];
#pragma unroll
  for (int k = 5; k >= 0; --k) {
    x[k] = __shfl_sync(kFull, s * inv[k], k);
    if (lane < k) s -= a[k] * x[k];
  }
  const bool ok = (m[19] > 0.f) || (info_trace > 0.f);
  float eps[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) eps[i] = ok ? -x[i] : 0.f;
  return compose(se3_exp(eps), pose);
}

template <int PPT>
__global__ void __launch_bounds__(kMaxThreads, 1) align_kernel(
    const float* __restrict__ pts, const unsigned char* __restrict__ valid,
    const float* __restrict__ cx, const float* __restrict__ cy, const float* __restrict__ cz,
    const float* __restrict__ cm, const float* __restrict__ params,
    const float* __restrict__ thr2_tab, const float* __restrict__ kc_tab, float* __restrict__ out,
    int N, int npad, int C, int maxit, int gn_inner, int cs, int slice, int planes_in_smem,
    float min_t, float min_r, float hook_t, float hook_r, float damp, float weight) {
  extern __shared__ float4 smem_planes[];
  __shared__ float red[kMaxWarps][kMom];  // [warp][value]
  __shared__ float part[2][kMaxCluster][kMom];  // [buffer][rank][value], written by the whole cluster
  __shared__ float mom[kMom];             // the cluster's sums, for warp 0
  __shared__ Pose s_pose;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / cs;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x;
  const int nwarps = nthreads >> 5;
  const int s0 = rank * slice;
  int buf = 0;  // the partial slot of the next reduction

  // ---- the slice's candidate planes: shared memory, or global memory ----
  const size_t cb = (size_t)b * C * npad;
  const float *Px, *Py, *Pz, *Pm;
  int cstride;
  if (planes_in_smem) {
    float* sp = reinterpret_cast<float*>(smem_planes);
    const int chunks = slice >> 2;  // 16-byte chunks per plane row
    const int total = 4 * C * chunks;
    for (int k = tid; k < total; k += nthreads) {
      const int qc = k / chunks, ch = k - qc * chunks;  // qc = plane * C + c
      const int q = qc / C, c = qc - q * C;
      const float* src = (q == 0 ? cx : q == 1 ? cy : q == 2 ? cz : cm) + cb + (size_t)c * npad + s0 + 4 * ch;
      cp_async16(sp + (size_t)qc * slice + 4 * ch, src);
    }
    Px = sp; Py = sp + C * slice; Pz = sp + 2 * C * slice; Pm = sp + 3 * C * slice;
    cstride = slice;
  } else {
    Px = cx + cb + s0; Py = cy + cb + s0; Pz = cz + cb + s0; Pm = cm + cb + s0;
    cstride = npad;
  }

  // ---- per-instance constants (uniform) ----
  const float* prm = params + (size_t)b * kParams;
  const float* thr2_b = thr2_tab + (size_t)b * maxit;
  const float* kc_b = kc_tab + (size_t)b * maxit;
  Pose prior, href, cur;
  for (int i = 0; i < 9; ++i) { cur.R[i] = prm[2 + i]; prior.R[i] = prm[14 + i]; href.R[i] = prm[26 + i]; }
  for (int i = 0; i < 3; ++i) { cur.t[i] = prm[11 + i]; prior.t[i] = prm[23 + i]; href.t[i] = prm[35 + i]; }
  const float* info = prm + 38;
  const float info_trace = info[0] + info[7] + info[14] + info[21] + info[28] + info[35];
  const Pose prior_inv = inverse(prior);
  float info_row[6];
  for (int j = 0; j < 6; ++j) info_row[j] = (warp == 0 && lane < 6) ? info[6 * lane + j] : 0.f;
  const int limit = (int)prm[0];
  const int it_first = (int)prm[1];

  // ---- the thread's points, kept in registers ----
  float px[PPT], py[PPT], pz[PPT], tx[PPT], ty[PPT], tz[PPT], pr[PPT];
  unsigned inslice = 0, vbits = 0;
  const float* P = pts + (size_t)b * N * 3;
  const unsigned char* V = valid + (size_t)b * N;
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    const int l = j * nthreads + tid, i = s0 + l;
    px[j] = py[j] = pz[j] = 0.f;
    tx[j] = ty[j] = tz[j] = pr[j] = 0.f;
    if (l < slice) inslice |= 1u << j;
    if (l < slice && i < N) {
      px[j] = P[3 * i]; py[j] = P[3 * i + 1]; pz[j] = P[3 * i + 2];
      if (V[i]) vbits |= 1u << j;
    }
  }

  // Reduce v over the cluster into mom (warp 0); `tail` runs on warp 0
  // between the barrier's arrive and wait.
  auto reduce = [&](float* v, auto&& tail) {
    const float w = warp_reduce_transposed(v, lane);
    if (lane < kMom) red[warp][lane] = w;
    __syncthreads();
    // warp w sums the CTA's partials (every warp in the same order) and
    // stores them into ranks w, w + nwarps, ...: the remote stores of a pass
    // are spread over the warps
    if (warp < cs && lane < kMom) {
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < kMaxWarps; ++k)
        if (k < nwarps) s += red[k][lane];
      for (int r = warp; r < cs; r += nwarps) cluster.map_shared_rank(&part[buf][rank][0], r)[lane] = s;
    }
    cluster_arrive();
    if (warp == 0) tail();
    cluster_wait();
    if (warp == 0) {
      float s = 0.f;
      if (lane < kMom) {
#pragma unroll
        for (int r = 0; r < kMaxCluster; ++r)
          if (r < cs) s += part[buf][r][lane];
        mom[lane] = s;
      }
      __syncwarp();
    }
    buf ^= 1;
  };
  auto nothing = [] {};

  // every CTA of the cluster must have started before any writes its slots;
  // after the last reduction's barrier no CTA touches another's memory
  cluster_arrive();
  cluster_wait();

  // initial valid count
  float v[kMom];
  for (int k = 0; k < kMom; ++k) v[k] = 0.f;
  v[19] = (float)__popc(vbits);
  reduce(v, nothing);
  const float nvalid = (warp == 0) ? mom[19] : 0.f;
  if (planes_in_smem) cp_async_wait_all();
  __syncthreads();

  // match every point at `pose`: nearest of its C candidates (first-min,
  // masked by cm), paired when inside thr2; optionally keep the pairing and
  // accumulate the moments
  auto match_pass = [&](const Pose& pose, float thr2, float kc, bool moments) {
    for (int k = 0; k < kMom; ++k) v[k] = 0.f;
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
      if (!(inslice >> j & 1u)) continue;
      const int l = j * nthreads + tid;
      const float qx = pose.R[0] * px[j] + pose.R[1] * py[j] + pose.R[2] * pz[j] + pose.t[0];
      const float qy = pose.R[3] * px[j] + pose.R[4] * py[j] + pose.R[5] * pz[j] + pose.t[1];
      const float qz = pose.R[6] * px[j] + pose.R[7] * py[j] + pose.R[8] * pz[j] + pose.t[2];
      float dmin = kBig;
      int best = 0;
      bool found = false;
      for (int c = 0; c < C; ++c) {
        const int o = c * cstride + l;
        float d2 = kBig;
        if (Pm[o] > 0.f) {
          const float dx = Px[o] - qx, dy = Py[o] - qy, dz = Pz[o] - qz;
          d2 = dx * dx + dy * dy + dz * dz;
        }
        if (d2 < dmin || (!found && d2 <= dmin)) { dmin = d2; best = c; found = true; }
      }
      const int ob = best * cstride + l;
      const float pair = ((vbits >> j & 1u) && dmin < thr2 && dmin < kBig) ? 1.f : 0.f;
      v[19] += pair;
      if (moments) {
        tx[j] = Px[ob]; ty[j] = Py[ob]; tz[j] = Pz[ob]; pr[j] = pair;
        add_moments(v, qx, qy, qz, tx[j], ty[j], tz[j], pair, kc, weight);
      }
    }
  };

  // moments at `pose` with the pairings of the iteration's match pass
  auto moment_pass = [&](const Pose& pose, float kc) {
    for (int k = 0; k < kMom; ++k) v[k] = 0.f;
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
      if (!(inslice >> j & 1u)) continue;
      const float qx = pose.R[0] * px[j] + pose.R[1] * py[j] + pose.R[2] * pz[j] + pose.t[0];
      const float qy = pose.R[3] * px[j] + pose.R[4] * py[j] + pose.R[5] * pz[j] + pose.t[1];
      const float qz = pose.R[6] * px[j] + pose.R[7] * py[j] + pose.R[8] * pz[j] + pose.t[2];
      add_moments(v, qx, qy, qz, tx[j], ty[j], tz[j], pr[j], kc, weight);
    }
  };

  int it = it_first;
  bool hook = false, conv = false;
  while (it < limit && !hook && !conv) {  // uniform across the cluster
    const int ti = min(it, maxit - 1);
    const float thr2 = thr2_b[ti], kc = kc_b[ti];
    const Pose start = cur;
    float npair = 0.f;
    for (int g = 0; g < gn_inner; ++g) {
      if (g == 0) match_pass(cur, thr2, kc, true);
      else moment_pass(cur, kc);
      float rp[6];
      reduce(v, [&] { se3_log(compose(prior_inv, cur), rp); });
      if (warp == 0) {
        float m[kMom];
        for (int k = 0; k < kMom; ++k) m[k] = mom[k];
        if (g == 0) npair = m[19];
        m[19] = npair;
        const Pose nxt = gn_update_warp(cur, m, rp, info_row, info_trace, damp, lane);
        if (lane == 0) s_pose = nxt;
      }
      __syncthreads();
      cur = s_pose;
    }
    // exit tests, on every thread from the shared pose (uniform)
    float Rt[9], dR[9], hRt[9], hR[9];
    transpose(start.R, Rt);
    mat_mul(Rt, cur.R, dR);
    transpose(href.R, hRt);
    mat_mul(hRt, cur.R, hR);
    float dt2 = 0.f, ht2 = 0.f;
    for (int i = 0; i < 3; ++i) {
      const float d = cur.t[i] - start.t[i], h = cur.t[i] - href.t[i];
      dt2 += d * d;
      ht2 += h * h;
    }
    conv = dt2 < min_t && sin_angle2(dR) < min_r;
    hook = ht2 > hook_t || sin_angle2(hR) > hook_r;
    ++it;
  }

  // paired-ratio quality at the final pose
  match_pass(cur, thr2_b[min(it, maxit - 1)], 0.f, false);
  reduce(v, nothing);
  if (rank == 0 && tid == 0) {
    float* o = out + (size_t)b * 16;
    for (int i = 0; i < 9; ++i) o[i] = cur.R[i];
    for (int i = 0; i < 3; ++i) o[9 + i] = cur.t[i];
    o[12] = (float)it;
    o[13] = hook ? 1.f : 0.f;
    o[14] = conv ? 1.f : 0.f;
    o[15] = mom[19] / fmaxf(nvalid, 1.0f);
  }
}

constexpr int kMaxDevices = 64;

template <int PPT>
cudaError_t launch(cudaLaunchConfig_t& cfg, int cs, const float* pts, const unsigned char* valid,
                   const float* cx, const float* cy, const float* cz, const float* cm,
                   const float* params, const float* thr2, const float* kc, float* out, int N,
                   int npad, int C, int maxit, int gn_inner, int slice, int planes_in_smem,
                   float min_t, float min_r, float hook_t, float hook_r, float damp, float weight) {
  auto kernel = align_kernel<PPT>;
  // The function attributes and the schedulability check, once per shape.  A
  // refusal is returned after clearing the runtime's last-error state, so
  // that it does not surface again at the next launch.
  auto refuse = [](cudaError_t e) {
    cudaGetLastError();
    return e;
  };
  // Function attributes are the current device's: the check is kept per
  // device, so that one process may launch on several cards.
  struct Checked {
    int cs = 0, threads = 0;
    size_t smem = ~(size_t)0;
  };
  static Checked checked[kMaxDevices];
  int dev = 0;
  cudaError_t de = cudaGetDevice(&dev);
  if (de != cudaSuccess) return refuse(de);
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  Checked& ck = checked[dev];
  if (cs != ck.cs || (int)cfg.blockDim.x != ck.threads || cfg.dynamicSmemBytes != ck.smem) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return refuse(e);
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)cfg.dynamicSmemBytes);
    if (e != cudaSuccess) return refuse(e);
    int clusters = 0;
    e = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (e != cudaSuccess) return refuse(e);
    if (clusters < 1) return cudaErrorLaunchOutOfResources;  // the cluster cannot be scheduled
    ck.cs = cs;
    ck.threads = (int)cfg.blockDim.x;
    ck.smem = cfg.dynamicSmemBytes;
  }
  cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, pts, valid, cx, cy, cz, cm, params, thr2, kc, out,
                                     N, npad, C, maxit, gn_inner, cs, slice, planes_in_smem, min_t,
                                     min_r, hook_t, hook_r, damp, weight);
  if (e != cudaSuccess) return refuse(e);
  return cudaGetLastError();
}

}  // namespace

// Launch B instances as B clusters of cs CTAs of `threads` threads, PPT
// points per thread, slice = npad / cs points per CTA; smem_bytes of dynamic
// shared memory hold the slice's planes when planes_in_smem.  Returns a
// cudaError_t code: non-zero when the attributes, the cluster or the launch
// are refused (a cluster that cannot be scheduled included).
extern "C" int align_launch(const float* pts, const unsigned char* valid, const float* cx,
                            const float* cy, const float* cz, const float* cm,
                            const float* params, const float* thr2, const float* kc, float* out,
                            int B, int N, int npad, int C, int maxit, int gn_inner, int cs,
                            int threads, int ppt, int slice, int planes_in_smem, int smem_bytes,
                            float min_t, float min_r, float hook_t, float hook_r, float damp,
                            float weight, void* stream) {
  if (cs < 1 || cs > kMaxCluster || threads < 32 || threads > kMaxThreads) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * cs, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
#define ALIGN_ARGS cfg, cs, pts, valid, cx, cy, cz, cm, params, thr2, kc, out, N, npad, C, maxit, \
    gn_inner, slice, planes_in_smem, min_t, min_r, hook_t, hook_r, damp, weight
  switch (ppt) {
    case 1: return (int)launch<1>(ALIGN_ARGS);
    case 2: return (int)launch<2>(ALIGN_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef ALIGN_ARGS
}
