// Kernels B1 and B2: fused neighbourhood capture and phase-2 reselect.
//
// Replaces mola_lidar_odometry_tpu/ops/pallas_capture.py::capture_planar
// (pallas_call at :257) and ::capture_planar_reselect (pallas_call at :335),
// the two uses of its _make_kernel(..., reselect) body (:60-187).
//
// One warp handles one (instance b, probe p, query i):
//   * B1 derives the probe's bucket row exactly as the JAX package's XLA
//     row gather does (floor(q / vs), octant step, Horner hash, spread-pad
//     of invalid queries), reads the 512-byte row with one 16-byte load per
//     lane, and optionally writes it to rows_out for B2;
//   * B2 reads the row B1 wrote;
//   * both derive the expected key from floor(q_cap * inv_vs), select the
//     way whose pkey and epoch match (the last matching way wins, way 0 when
//     none does), shuffle the way's K packed point words to lanes 0..K-1,
//     dequantize against the probe voxel, and keep the two nearest to q_live
//     with two warp argmin butterflies (first-min tie-break).
//
// Bound: bytes.  B1 moves 2 x 512 B per (b, p, i) (row read + row write),
// B2 512 B; a few dozen flops per row.  This file is built with -fmad=false
// and spells the rounding-sensitive arithmetic with __f*_rn intrinsics, so
// the output planes equal the plain PyTorch twin's bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kBig = 3.4e38f;
constexpr float kInvQ = 1.0f / 1024.0f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int wrap_hash(int cx, int cy, int cz, int nb) {
  // voxel_hash: Horner chain in int32 wraparound, then h ^ (h >> 16)
  unsigned h = (unsigned)cx * 73856093u + (unsigned)cy;
  h = h * 19349663u + (unsigned)cz;
  h = h * 83492791u;
  int hs = (int)h;
  hs = hs ^ (hs >> 16);  // arithmetic shift, as the JAX int32 >>
  return hs & (nb - 1);
}

__device__ __forceinline__ void probe_offset(int neighbors, int p, float* o) {
  if (neighbors == 27) {
    o[0] = (float)(p / 9 - 1); o[1] = (float)((p / 3) % 3 - 1); o[2] = (float)(p % 3 - 1);
  } else if (neighbors == 8) {
    o[0] = (float)(p / 4); o[1] = (float)((p / 2) % 2); o[2] = (float)(p % 2);
  } else if (neighbors == 4) {
    o[0] = (float)(p == 1); o[1] = (float)(p == 2); o[2] = (float)(p == 3);
  } else {
    o[0] = o[1] = o[2] = 0.0f;
  }
}

// warp argmin over (d, k) with the lowest k winning ties; every lane gets it
__device__ __forceinline__ void warp_argmin(float& d, int& k) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    float od = __shfl_xor_sync(kFull, d, off);
    int ok = __shfl_xor_sync(kFull, k, off);
    if (od < d || (od == d && ok < k)) { d = od; k = ok; }
  }
}

__global__ void capture_kernel(
    const int* __restrict__ src,  // B1: tables (B, NB, 128); B2: rows (B, P, npad, 128)
    const float* __restrict__ voxel_size, const float* __restrict__ inv_voxel_size,
    const int* __restrict__ epoch, const float* __restrict__ q_live,
    const float* __restrict__ q_cap, const unsigned char* __restrict__ valid,
    int* __restrict__ rows_out, float* __restrict__ cx, float* __restrict__ cy,
    float* __restrict__ cz, float* __restrict__ cm, int B, int N, int npad, int P,
    int neighbors, int K, int stride, int n_buckets, int reselect, int has_valid) {
  const int lane = threadIdx.x & 31;
  const long long w = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (w >= (long long)B * P * npad) return;  // uniform per warp
  const int i = (int)(w % npad);
  const int p = (int)((w / npad) % P);
  const int b = (int)(w / ((long long)npad * P));

  const bool in_range = i < N;
  const long long qi = ((long long)b * N + i) * 3;
  float ql[3] = {0.f, 0.f, 0.f}, qc[3] = {0.f, 0.f, 0.f};
  if (in_range) {
    for (int a = 0; a < 3; ++a) { ql[a] = q_live[qi + a]; qc[a] = q_cap[qi + a]; }
  }
  const bool vq = in_range && (!has_valid || valid[(long long)b * N + i]);
  const float vs = voxel_size[b], inv = inv_voxel_size[b];
  const bool signed_probe = neighbors == 4 || neighbors == 8;
  float off[3];
  probe_offset(neighbors, p, off);

  // ---- the bucket row (fused XLA gather of the JAX package) ----
  const long long row_id = ((long long)b * P + p) * npad + i;  // rows (B, P, npad)
  const int4* row;
  if (reselect) {
    row = reinterpret_cast<const int4*>(src) + row_id * 32;
  } else {
    int bucket;
    if (has_valid && !vq) {
      bucket = (int)(((long long)i * P + p) % n_buckets);  // spread-pad
    } else {
      int c[3];
      for (int a = 0; a < 3; ++a) {
        const float f = __fdiv_rn(qc[a], vs);  // voxel_coords: floor(q / vs)
        const float base = floorf(f);
        const int step = (__fsub_rn(f, __fadd_rn(base, 0.5f)) >= 0.f) ? 1 : -1;
        c[a] = (int)base + (int)off[a] * (signed_probe ? step : 1);
      }
      bucket = wrap_hash(c[0], c[1], c[2], n_buckets);
    }
    row = reinterpret_cast<const int4*>(src) + ((long long)b * n_buckets + bucket) * 32;
  }
  const int4 v = row[lane];
  if (rows_out != nullptr) reinterpret_cast<int4*>(rows_out)[row_id * 32 + lane] = v;

  // ---- expected key of the probe, from q_cap * inv_vs ----
  float e[3];
  for (int a = 0; a < 3; ++a) {
    const float t = __fmul_rn(qc[a], inv);
    const float base = floorf(t);
    const float s = signed_probe ? ((__fsub_rn(t, __fadd_rn(base, 0.5f)) >= 0.f) ? 1.f : -1.f) : 1.f;
    e[a] = __fadd_rn(base, __fmul_rn(off[a], s));
  }
  const unsigned ix = (unsigned)__float2int_rz(e[0]) & 4095u;
  const unsigned iy = (unsigned)__float2int_rz(e[1]) & 4095u;
  const unsigned iz = (unsigned)__float2int_rz(e[2]) & 255u;
  const int pk_exp = (int)((ix << 20) | (iy << 8) | iz);

  // ---- way select ----
  const int e16 = epoch[b] & 0xFFFF;
  const int W = 128 / stride;
  int wsel = 0;
  bool any_ok = false;
  for (int way = 0; way < W; ++way) {
    const int hl = way * stride / 4;
    const int pk = __shfl_sync(kFull, v.x, hl);
    const int st = __shfl_sync(kFull, v.y, hl);
    const bool ok = pk == pk_exp && ((st >> 16) & 0xFFFF) == e16;
    if (ok) wsel = way;
    any_ok = any_ok || ok;
  }
  const int cnt = __shfl_sync(kFull, v.y, wsel * stride / 4) & 0xFFFF;
  const bool live = any_ok && cnt > 0;

  // ---- lane k <- point word k of the selected way ----
  const int word = (lane < K) ? wsel * stride + 2 + lane : 0;
  const int sl = word >> 2, comp = word & 3;
  const int w0 = __shfl_sync(kFull, v.x, sl), w1 = __shfl_sync(kFull, v.y, sl);
  const int w2 = __shfl_sync(kFull, v.z, sl), w3 = __shfl_sync(kFull, v.w, sl);
  const int pw = comp == 0 ? w0 : comp == 1 ? w1 : comp == 2 ? w2 : w3;
  float xs[3], d2 = 0.f;
  for (int a = 0; a < 3; ++a) {
    const float pq = (float)((pw >> (20 - 10 * a)) & 1023);
    xs[a] = __fmul_rn(__fadd_rn(e[a], __fmul_rn(__fadd_rn(pq, 0.5f), kInvQ)), vs);
    const float d = __fsub_rn(xs[a], ql[a]);
    d2 = a == 0 ? __fmul_rn(d, d) : __fadd_rn(d2, __fmul_rn(d, d));
  }
  const bool kmask = live && lane < K && lane < cnt;
  d2 = kmask ? d2 : kBig;

  float d1 = d2;
  int k1 = lane;
  warp_argmin(d1, k1);
  float db = (lane == k1) ? kBig : d2;
  int k2 = lane;
  warp_argmin(db, k2);

  // gather the winners' coordinates (every lane takes part in the shuffles)
  const float x1 = __shfl_sync(kFull, xs[0], k1), y1 = __shfl_sync(kFull, xs[1], k1);
  const float z1 = __shfl_sync(kFull, xs[2], k1);
  const float x2 = __shfl_sync(kFull, xs[0], k2), y2 = __shfl_sync(kFull, xs[1], k2);
  const float z2 = __shfl_sync(kFull, xs[2], k2);
  if (lane == 0) {
    const float vm = (has_valid && !vq) ? 0.f : 1.f;
    const long long o1 = ((long long)b * 2 * P + p) * npad + i;
    const long long o2 = o1 + (long long)P * npad;
    cx[o1] = x1; cy[o1] = y1; cz[o1] = z1; cm[o1] = (d1 < kBig) ? vm : 0.f;
    cx[o2] = x2; cy[o2] = y2; cz[o2] = z2; cm[o2] = (db < kBig) ? vm : 0.f;
  }
}

}  // namespace

extern "C" int capture_launch(
    const int* src, const float* voxel_size, const float* inv_voxel_size, const int* epoch,
    const float* q_live, const float* q_cap, const unsigned char* valid, int* rows_out,
    float* cx, float* cy, float* cz, float* cm, int B, int N, int npad, int P, int neighbors,
    int K, int stride, int n_buckets, int reselect, int has_valid, void* stream) {
  const long long warps = (long long)B * P * npad;
  const int threads = 256;
  const long long blocks = (warps * 32 + threads - 1) / threads;
  capture_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      src, voxel_size, inv_voxel_size, epoch, q_live, q_cap, valid, rows_out, cx, cy, cz, cm,
      B, N, npad, P, neighbors, K, stride, n_buckets, reselect, has_valid);
  return (int)cudaGetLastError();
}
