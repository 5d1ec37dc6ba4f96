// Kernel B3: the whole ICP align loop of one fleet instance.
//
// Replaces mola_lidar_odometry_tpu/ops/pallas_icp.py::align_fused
// (_make_kernel(C, npad, gn_inner, maxit) at :225, pallas_call at :542).
//
// One thread block per instance.  Per iteration:
//   pass 0: every thread walks its strided share of the points, transforms
//           each by the current pose, picks the nearest of its C planar
//           candidates (first-min, masked by cm), stores the target and the
//           pair flag in `scratch`, and accumulates the 19 Gram moments of
//           the first Gauss-Newton step plus the pair count;
//   pass k: (k < gn_inner) recomputes the moments at the updated pose from
//           the stored pairings;
//   after each pass a block reduction feeds thread 0, which adds the prior
//   (information + SE(3)-log residual), solves the damped 6x6 system
//   without pivoting, and applies the SE(3)-exp update; then it tests step
//   convergence and the twist hook and broadcasts the loop decision.
// A last match pass gives the paired-ratio quality.
//
// Bound: latency.  Each iteration is a chain of (gn_inner + 1) block-wide
// passes and serial scalar solves; the candidate planes (16 x 4 x npad
// floats, ~0.8 MB per instance at the bench shape) stream from L2.  Only B
// of the card's SMs are busy; clusters and distributed shared memory are
// left for later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kBig = 3.4e38f;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMom = 20;  // 19 moments + pair count
constexpr int kParams = 74;

struct Pose { float R[9]; float t[3]; };

__device__ void mat_mul(const float* A, const float* B, float* out) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      out[3 * i + j] = A[3 * i] * B[j] + A[3 * i + 1] * B[3 + j] + A[3 * i + 2] * B[6 + j];
}

__device__ void mat_vec(const float* R, const float* v, float* out) {
  for (int i = 0; i < 3; ++i) out[i] = R[3 * i] * v[0] + R[3 * i + 1] * v[1] + R[3 * i + 2] * v[2];
}

__device__ void transpose(const float* R, float* out) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) out[3 * i + j] = R[3 * j + i];
}

__device__ Pose compose(const Pose& a, const Pose& b) {
  Pose o;
  mat_mul(a.R, b.R, o.R);
  mat_vec(a.R, b.t, o.t);
  for (int i = 0; i < 3; ++i) o.t[i] += a.t[i];
  return o;
}

__device__ Pose inverse(const Pose& p) {
  Pose o;
  transpose(p.R, o.R);
  mat_vec(o.R, p.t, o.t);
  for (int i = 0; i < 3; ++i) o.t[i] = -o.t[i];
  return o;
}

__device__ void sinc_coeffs(float t2, float& A, float& B, float& C) {
  const float t4 = t2 * t2, t6 = t4 * t2;
  A = 1.0f - t2 / 6.0f + t4 / 120.0f - t6 / 5040.0f;
  B = 0.5f - t2 / 24.0f + t4 / 720.0f - t6 / 40320.0f;
  C = 1.0f / 6.0f - t2 / 120.0f + t4 / 5040.0f - t6 / 362880.0f;
}

__device__ void axes_mats(const float* w, float* K, float* K2) {
  const float x = w[0], y = w[1], z = w[2];
  K[0] = 0.f; K[1] = -z; K[2] = y; K[3] = z; K[4] = 0.f; K[5] = -x; K[6] = -y; K[7] = x; K[8] = 0.f;
  const float xx = x * x, yy = y * y, zz = z * z;
  K2[0] = -(yy + zz); K2[1] = x * y; K2[2] = x * z;
  K2[3] = x * y; K2[4] = -(xx + zz); K2[5] = y * z;
  K2[6] = x * z; K2[7] = y * z; K2[8] = -(xx + yy);
}

__device__ Pose se3_exp(const float* xi) {
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

__device__ void se3_log(const Pose& p, float* xi) {
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

__device__ float sin_angle2(const float* R) {
  const float wx = (R[7] - R[5]) * 0.5f, wy = (R[2] - R[6]) * 0.5f, wz = (R[3] - R[1]) * 0.5f;
  return wx * wx + wy * wy + wz * wz;
}

__device__ void solve6(float* A, float* x, float damp) {  // A 6x6 row-major, in place
  const float scale = (A[0] + A[7] + A[14] + A[21] + A[28] + A[35]) / 6.0f + 1.0f;
  for (int i = 0; i < 6; ++i) A[7 * i] += damp * scale;
  for (int k = 0; k < 6; ++k) {
    const float inv = 1.0f / A[7 * k];
    for (int i = k + 1; i < 6; ++i) {
      const float f = A[6 * i + k] * inv;
      for (int j = k + 1; j < 6; ++j) A[6 * i + j] -= f * A[6 * k + j];
      x[i] -= f * x[k];
    }
  }
  for (int k = 5; k >= 0; --k) {
    float s = x[k];
    for (int j = k + 1; j < 6; ++j) s -= A[6 * k + j] * x[j];
    x[k] = s / A[7 * k];
  }
}

// Block-wide sum of kMom per-thread values into red_out (valid on all threads
// after the trailing __syncthreads).
__device__ void block_reduce(float* v, float (*red)[kMom], float* red_out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < kMom; ++k) {
    float s = v[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0) red[warp][k] = s;
  }
  __syncthreads();
  if (threadIdx.x < kMom) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += red[w][threadIdx.x];
    red_out[threadIdx.x] = s;
  }
  __syncthreads();
}

// One robust Gauss-Newton update of `pose` from the reduced moments m.
__device__ Pose gn_update(const Pose& pose, const float* m, const Pose& prior_inv,
                          const float* info, float info_trace, float damp) {
  const float S = m[0], Sx = m[1], Sy = m[2], Sz = m[3];
  const float Sxx = m[4], Syy = m[5], Szz = m[6], Sxy = m[7], Sxz = m[8], Syz = m[9];
  float H[36], b[6];
  for (int i = 0; i < 36; ++i) H[i] = 0.f;
  const float SK[9] = {0.f, -Sz, Sy, Sz, 0.f, -Sx, -Sy, Sx, 0.f};
  const float trS = Sxx + Syy + Szz;
  const float KtK[9] = {trS - Sxx, -Sxy, -Sxz, -Sxy, trS - Syy, -Syz, -Sxz, -Syz, trS - Szz};
  for (int i = 0; i < 3; ++i) {
    H[7 * i] = S;
    for (int j = 0; j < 3; ++j) {
      H[6 * i + 3 + j] = -SK[3 * i + j];
      H[6 * (3 + i) + j] = SK[3 * i + j];
      H[6 * (3 + i) + 3 + j] = KtK[3 * i + j];
    }
  }
  b[0] = m[10]; b[1] = m[11]; b[2] = m[12];
  b[3] = m[13] - m[14];  // G26 - G35
  b[4] = m[15] - m[16];  // G34 - G16
  b[5] = m[17] - m[18];  // G15 - G24
  float rp[6];
  se3_log(compose(prior_inv, pose), rp);
  for (int i = 0; i < 6; ++i)
    for (int j = 0; j < 6; ++j) {
      H[6 * i + j] += info[6 * i + j];
      b[i] += info[6 * i + j] * rp[j];
    }
  solve6(H, b, damp);
  const bool ok = (m[19] > 0.f) || (info_trace > 0.f);
  float eps[6];
  for (int i = 0; i < 6; ++i) eps[i] = ok ? -b[i] : 0.f;
  return compose(se3_exp(eps), pose);
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

__global__ void __launch_bounds__(kThreads) align_kernel(
    const float* __restrict__ pts, const unsigned char* __restrict__ valid,
    const float* __restrict__ cx, const float* __restrict__ cy, const float* __restrict__ cz,
    const float* __restrict__ cm, const float* __restrict__ params,
    const float* __restrict__ thr2_tab, const float* __restrict__ kc_tab,
    float* __restrict__ scratch, float* __restrict__ out, int N, int npad, int C, int maxit,
    int gn_inner, float min_t, float min_r, float hook_t, float hook_r, float damp,
    float weight) {
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  __shared__ float red[kWarps][kMom];
  __shared__ float mom[kMom];
  __shared__ Pose s_pose;
  __shared__ int s_go, s_it;
  __shared__ float s_nvalid;

  const float* prm = params + (long long)b * kParams;
  const float* P = pts + (long long)b * N * 3;
  const unsigned char* V = valid + (long long)b * N;
  const long long cb = (long long)b * C * npad;
  float* tgt = scratch + (long long)b * 4 * npad;
  const float* thr2_b = thr2_tab + (long long)b * maxit;
  const float* kc_b = kc_tab + (long long)b * maxit;

  // per-instance constants (every thread keeps its own copy)
  Pose prior, href;
  const float* info = prm + 38;  // read by the solving thread only
  for (int i = 0; i < 9; ++i) { prior.R[i] = prm[14 + i]; href.R[i] = prm[26 + i]; }
  for (int i = 0; i < 3; ++i) { prior.t[i] = prm[23 + i]; href.t[i] = prm[35 + i]; }
  const float info_trace = info[0] + info[7] + info[14] + info[21] + info[28] + info[35];
  const Pose prior_inv = inverse(prior);
  const int limit = (int)prm[0];

  float v[kMom];
  for (int k = 0; k < kMom; ++k) v[k] = 0.f;
  for (int i = tid; i < N; i += kThreads) v[19] += V[i] ? 1.f : 0.f;
  block_reduce(v, red, mom);
  if (tid == 0) {
    s_nvalid = mom[19];
    for (int i = 0; i < 9; ++i) s_pose.R[i] = prm[2 + i];
    for (int i = 0; i < 3; ++i) s_pose.t[i] = prm[11 + i];
    s_it = (int)prm[1];
    s_go = s_it < limit;
  }
  __syncthreads();

  // match at `pose` (pass 0 of an iteration, and the final quality pass)
  auto match_pass = [&](const Pose& pose, float thr2, float kc, bool moments) {
    for (int k = 0; k < kMom; ++k) v[k] = 0.f;
    for (int i = tid; i < npad; i += kThreads) {
      float px = 0.f, py = 0.f, pz = 0.f, pv = 0.f;
      if (i < N) { px = P[3 * i]; py = P[3 * i + 1]; pz = P[3 * i + 2]; pv = V[i] ? 1.f : 0.f; }
      const float qx = pose.R[0] * px + pose.R[1] * py + pose.R[2] * pz + pose.t[0];
      const float qy = pose.R[3] * px + pose.R[4] * py + pose.R[5] * pz + pose.t[1];
      const float qz = pose.R[6] * px + pose.R[7] * py + pose.R[8] * pz + pose.t[2];
      float dmin = kBig;
      int best = 0;
      bool found = false;
      for (int c = 0; c < C; ++c) {
        const long long o = cb + (long long)c * npad + i;
        float d2 = kBig;
        if (cm[o] > 0.f) {
          const float dx = cx[o] - qx, dy = cy[o] - qy, dz = cz[o] - qz;
          d2 = dx * dx + dy * dy + dz * dz;
        }
        if (d2 < dmin || (!found && d2 <= dmin)) { dmin = d2; best = c; found = true; }
      }
      const long long ob = cb + (long long)best * npad + i;
      const float tx = cx[ob], ty = cy[ob], tz = cz[ob];
      const float pair = (pv > 0.f && dmin < thr2 && dmin < kBig) ? 1.f : 0.f;
      v[19] += pair;
      if (moments) {
        tgt[i] = tx; tgt[npad + i] = ty; tgt[2 * npad + i] = tz; tgt[3 * npad + i] = pair;
        add_moments(v, qx, qy, qz, tx, ty, tz, pair, kc, weight);
      }
    }
    block_reduce(v, red, mom);
  };

  while (s_go) {
    const int it = s_it;
    const int ti = min(it, maxit - 1);
    const float thr2 = thr2_b[ti], kc = kc_b[ti];
    const Pose start = s_pose;
    match_pass(start, thr2, kc, true);
    const float npair = mom[19];
    Pose cur = start;
    for (int g = 0; g < gn_inner; ++g) {
      if (g > 0) {  // moments at the updated pose, pairings fixed
        for (int k = 0; k < kMom; ++k) v[k] = 0.f;
        for (int i = tid; i < npad; i += kThreads) {
          float px = 0.f, py = 0.f, pz = 0.f;
          if (i < N) { px = P[3 * i]; py = P[3 * i + 1]; pz = P[3 * i + 2]; }
          const float tpx = cur.R[0] * px + cur.R[1] * py + cur.R[2] * pz + cur.t[0];
          const float tpy = cur.R[3] * px + cur.R[4] * py + cur.R[5] * pz + cur.t[1];
          const float tpz = cur.R[6] * px + cur.R[7] * py + cur.R[8] * pz + cur.t[2];
          add_moments(v, tpx, tpy, tpz, tgt[i], tgt[npad + i], tgt[2 * npad + i],
                      tgt[3 * npad + i], kc, weight);
        }
        block_reduce(v, red, mom);
      }
      if (tid == 0) {
        float m[kMom];
        for (int k = 0; k < 19; ++k) m[k] = mom[k];
        m[19] = npair;
        s_pose = gn_update(cur, m, prior_inv, info, info_trace, damp);
      }
      __syncthreads();
      cur = s_pose;
    }
    if (tid == 0) {
      float Rt[9], dR[9], hRt[9], hR[9];
      transpose(start.R, Rt);
      mat_mul(Rt, cur.R, dR);
      float dt2 = 0.f, ht2 = 0.f;
      for (int i = 0; i < 3; ++i) {
        const float d = cur.t[i] - start.t[i], h = cur.t[i] - href.t[i];
        dt2 += d * d;
        ht2 += h * h;
      }
      transpose(href.R, hRt);
      mat_mul(hRt, cur.R, hR);
      const bool conv = dt2 < min_t && sin_angle2(dR) < min_r;
      const bool hook = ht2 > hook_t || sin_angle2(hR) > hook_r;
      s_it = it + 1;
      s_go = !conv && !hook && s_it < limit;
      out[(long long)b * 16 + 13] = hook ? 1.f : 0.f;
      out[(long long)b * 16 + 14] = conv ? 1.f : 0.f;
    }
    __syncthreads();
  }

  const Pose fin = s_pose;
  const int it = s_it;
  match_pass(fin, thr2_b[min(it, maxit - 1)], 0.f, false);
  if (tid == 0) {
    float* o = out + (long long)b * 16;
    for (int i = 0; i < 9; ++i) o[i] = fin.R[i];
    for (int i = 0; i < 3; ++i) o[9 + i] = fin.t[i];
    o[12] = (float)it;
    if (it == (int)prm[1]) { o[13] = 0.f; o[14] = 0.f; }  // loop never ran
    o[15] = mom[19] / fmaxf(s_nvalid, 1.0f);
  }
}

}  // namespace

extern "C" int align_launch(const float* pts, const unsigned char* valid, const float* cx,
                            const float* cy, const float* cz, const float* cm,
                            const float* params, const float* thr2, const float* kc,
                            float* scratch, float* out, int B, int N, int npad, int C, int maxit,
                            int gn_inner, float min_t, float min_r, float hook_t, float hook_r,
                            float damp, float weight, void* stream) {
  align_kernel<<<B, kThreads, 0, (cudaStream_t)stream>>>(
      pts, valid, cx, cy, cz, cm, params, thr2, kc, scratch, out, N, npad, C, maxit, gn_inner,
      min_t, min_r, hook_t, hook_r, damp, weight);
  return (int)cudaGetLastError();
}
