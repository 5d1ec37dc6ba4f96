// Kernels B1 and B2: fused neighbourhood capture and phase-2 reselect.
//
// Replaces mola_lidar_odometry_tpu/ops/pallas_capture.py::capture_planar
// (pallas_call at :257) and ::capture_planar_reselect (pallas_call at :335),
// the two uses of its _make_kernel(..., reselect) body (:60-187).
//
// B1, capture_gather_kernel: one thread per (instance b, probe p, query i).
//   * What bounds it: bytes.  It reads the B*P*npad probed 512-byte bucket
//     rows (the distinct ones from DRAM, repeats from L2) and writes them all
//     out once for B2 (about 100 MB each way at the bench shape); the
//     selection is a few hundred simple operations per query.  Its first
//     design (one warp per query, ~60 shuffles to select one query and the
//     key derivation repeated on 32 lanes) was bound by instruction issue.
//   * Each thread derives its probe's bucket row exactly as the JAX
//     package's XLA row gather does (floor(q / vs), octant step, Horner
//     hash, spread-pad of invalid queries) in 32-bit index arithmetic.
//   * Each lane moves its own 512-byte row with two TMA bulk copies: table
//     -> shared memory (the warp's 32 copies complete one transaction
//     barrier), then shared memory -> rows_out, asynchronously, while the
//     thread selects from the staged row.  No thread spends registers or
//     instructions on the row traffic.  The staged row stride is padded by
//     16 bytes, so each thread's 16-byte reads of its own row hit distinct
//     bank groups within every quarter warp.
//   * Each thread then reads its own row's way headers and its way's K
//     point words, dequantizes them, and takes the top-2 by two serial
//     first-min scans (the lowest index wins ties; the second scan puts kBig
//     in place of the first pick), as the warp butterflies of B2 do.
//
// B2, reselect_kernel: one warp per (b, p, i) on the row B1 wrote, with the
//   same selection spread over the lanes (16-byte row read, way select by
//   shuffles, two warp argmin butterflies).  Bound by bytes: 512 B per row.
//
// Both derive the expected key from floor(q_cap * inv_vs) and select the way
// whose pkey and epoch match (the last matching way wins, way 0 when none
// does).  This file is built with -fmad=false and spells the
// rounding-sensitive arithmetic with __f*_rn intrinsics, so the output
// planes equal the plain PyTorch twin's bit for bit.

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

// ---- mbarrier and bulk-copy (TMA) helpers ----
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, unsigned parity) {
  unsigned ok;
  asm volatile(
      "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return ok != 0;
}

// bulk copy global -> shared; its bytes complete a transaction on bar
__device__ __forceinline__ void bulk_load(void* smem, const void* gmem, unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_addr(smem)),
      "l"(gmem), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// bulk copy shared -> global, committed as this thread's bulk group
__device__ __forceinline__ void bulk_store(void* gmem, const void* smem, unsigned bytes) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(gmem),
               "r"(smem_addr(smem)), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// the thread's bulk stores have read their shared memory
__device__ __forceinline__ void bulk_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

constexpr int kRowStride = 128 + 4;  // staged row: 128 words + 16 bytes of padding
constexpr int kGatherWarps = 2;      // warps per block, each on its own 32 queries
constexpr int kMaxK = 32;

// the probe's expected packed key from q_cap * inv_vs (and the dequantization
// base e of its voxel)
__device__ __forceinline__ int expected_key(const float* qc, float inv, const float* off,
                                            bool signed_probe, float* e) {
  for (int a = 0; a < 3; ++a) {
    const float t = __fmul_rn(qc[a], inv);
    const float base = floorf(t);
    const float s = signed_probe ? ((__fsub_rn(t, __fadd_rn(base, 0.5f)) >= 0.f) ? 1.f : -1.f) : 1.f;
    e[a] = __fadd_rn(base, __fmul_rn(off[a], s));
  }
  const unsigned ix = (unsigned)__float2int_rz(e[0]) & 4095u;
  const unsigned iy = (unsigned)__float2int_rz(e[1]) & 4095u;
  const unsigned iz = (unsigned)__float2int_rz(e[2]) & 255u;
  return (int)((ix << 20) | (iy << 8) | iz);
}

// dequantize packed point word pw against the probe voxel e; d2 to ql
__device__ __forceinline__ float dequant(int pw, const float* e, float vs, const float* ql, float* xs) {
  float d2 = 0.f;
  for (int a = 0; a < 3; ++a) {
    const float pq = (float)((pw >> (20 - 10 * a)) & 1023);
    xs[a] = __fmul_rn(__fadd_rn(e[a], __fmul_rn(__fadd_rn(pq, 0.5f), kInvQ)), vs);
    const float d = __fsub_rn(xs[a], ql[a]);
    d2 = a == 0 ? __fmul_rn(d, d) : __fadd_rn(d2, __fmul_rn(d, d));
  }
  return d2;
}

// grid (ceil(npad / (32 * kGatherWarps)), P, B), block 32 * kGatherWarps
__global__ void __launch_bounds__(32 * kGatherWarps) capture_gather_kernel(
    const int* __restrict__ table,  // (B, n_buckets, 128)
    const float* __restrict__ voxel_size, const float* __restrict__ inv_voxel_size,
    const int* __restrict__ epoch, const float* __restrict__ q,
    const unsigned char* __restrict__ valid, int* __restrict__ rows_out, float* __restrict__ cx,
    float* __restrict__ cy, float* __restrict__ cz, float* __restrict__ cm, int N, int npad,
    int P, int neighbors, int K, int stride, int W, int n_buckets, int has_valid) {
  __shared__ __align__(16) int srow[kGatherWarps][32 * kRowStride];
  __shared__ __align__(8) uint64_t bar[kGatherWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int i0 = (blockIdx.x * kGatherWarps + warp) * 32;
  if (i0 >= npad) return;  // uniform per warp
  const int i = i0 + lane, p = blockIdx.y, b = blockIdx.z;

  const bool in_range = i < N;
  float ql[3] = {0.f, 0.f, 0.f};
  if (in_range) {
    const float* qi = q + ((size_t)b * N + i) * 3;
    ql[0] = qi[0]; ql[1] = qi[1]; ql[2] = qi[2];
  }
  const bool vq = in_range && (!has_valid || valid[(size_t)b * N + i]);
  const float vs = voxel_size[b], inv = inv_voxel_size[b];
  const bool signed_probe = neighbors == 4 || neighbors == 8;
  float off[3];
  probe_offset(neighbors, p, off);

  // ---- the bucket row (fused XLA gather of the JAX package) ----
  int bucket;
  if (has_valid && !vq) {
    bucket = (int)((unsigned)(i * P + p) % (unsigned)n_buckets);  // spread-pad
  } else {
    int c[3];
    for (int a = 0; a < 3; ++a) {
      const float f = __fdiv_rn(ql[a], vs);  // voxel_coords: floor(q / vs)
      const float base = floorf(f);
      const int step = (__fsub_rn(f, __fadd_rn(base, 0.5f)) >= 0.f) ? 1 : -1;
      c[a] = (int)base + (int)off[a] * (signed_probe ? step : 1);
    }
    bucket = wrap_hash(c[0], c[1], c[2], n_buckets);
  }

  // ---- stage the warp's 32 rows: each lane bulk-copies its own 512-byte
  // row (one TMA transaction on the warp's barrier), then bulk-copies it on
  // to rows_out, (B, P, npad, 128), while it selects from it ----
  int* row = srow[warp] + lane * kRowStride;
  if (lane == 0) {
    mbar_init(&bar[warp], 1);
    mbar_arrive_expect_tx(&bar[warp], 32 * 512);
  }
  __syncwarp();
  bulk_load(row, table + ((size_t)b * n_buckets + bucket) * 128, 512, &bar[warp]);
  while (!mbar_try_wait(&bar[warp], 0)) {
  }
  if (rows_out != nullptr) bulk_store(rows_out + ((size_t)(b * P + p) * npad + i) * 128, row, 512);

  // ---- this thread's own row: way select ----
  float e[3];
  const int pk_exp = expected_key(ql, inv, off, signed_probe, e);
  const int e16 = epoch[b] & 0xFFFF;
  int wsel = 0, st = 0;
  bool any_ok = false;
  for (int way = 0; way < W; ++way) {
    const int4 h = *reinterpret_cast<const int4*>(row + way * stride);
    const bool ok = h.x == pk_exp && ((h.y >> 16) & 0xFFFF) == e16;
    if (way == 0 || ok) st = h.y;
    if (ok) wsel = way;
    any_ok = any_ok || ok;
  }
  const int cnt = st & 0xFFFF;
  const bool live = any_ok && cnt > 0;

  // ---- the way's K point words (16-byte reads), distances ----
  const int4* wp = reinterpret_cast<const int4*>(row + wsel * stride);
  int words[4 * ((kMaxK + 2 + 3) / 4)];
#pragma unroll
  for (int c = 0; c < (kMaxK + 2 + 3) / 4; ++c) {
    int4 x = make_int4(0, 0, 0, 0);
    if (4 * c < 2 + K) x = wp[c];
    words[4 * c] = x.x; words[4 * c + 1] = x.y; words[4 * c + 2] = x.z; words[4 * c + 3] = x.w;
  }
  float dk[kMaxK];
  float xs[3];
#pragma unroll
  for (int k = 0; k < kMaxK; ++k) {
    dk[k] = kBig;
    if (k < K) {
      const float d2 = dequant(words[2 + k], e, vs, ql, xs);
      if (live && k < cnt) dk[k] = d2;
    }
  }
  // top-2: two first-min scans over k < K; the second with kBig at the first
  float d1 = dk[0];
  int w1 = words[2], k1 = 0;
#pragma unroll
  for (int k = 1; k < kMaxK; ++k)
    if (k < K && dk[k] < d1) { d1 = dk[k]; k1 = k; w1 = words[2 + k]; }
  float db = (k1 == 0) ? kBig : dk[0];
  int w2 = words[2];
#pragma unroll
  for (int k = 1; k < kMaxK; ++k) {
    const float d = (k == k1) ? kBig : dk[k];
    if (k < K && d < db) { db = d; w2 = words[2 + k]; }
  }
  float x1[3], x2[3];
  dequant(w1, e, vs, ql, x1);
  dequant(w2, e, vs, ql, x2);

  const float vm = (has_valid && !vq) ? 0.f : 1.f;
  const size_t o1 = (size_t)(b * 2 * P + p) * npad + i;
  const size_t o2 = o1 + (size_t)P * npad;
  cx[o1] = x1[0]; cy[o1] = x1[1]; cz[o1] = x1[2]; cm[o1] = (d1 < kBig) ? vm : 0.f;
  cx[o2] = x2[0]; cy[o2] = x2[1]; cz[o2] = x2[2]; cm[o2] = (db < kBig) ? vm : 0.f;
  if (rows_out != nullptr) bulk_store_wait_read();  // the row stays put until the store has read it
}

__global__ void reselect_kernel(
    const int* __restrict__ rows,  // (B, P, npad, 128), written by B1
    const float* __restrict__ voxel_size, const float* __restrict__ inv_voxel_size,
    const int* __restrict__ epoch, const float* __restrict__ q_live,
    const float* __restrict__ q_cap, const unsigned char* __restrict__ valid,
    float* __restrict__ cx, float* __restrict__ cy, float* __restrict__ cz,
    float* __restrict__ cm, int B, int N, int npad, int P, int neighbors, int K, int stride,
    int has_valid) {
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

  const long long row_id = ((long long)b * P + p) * npad + i;  // rows (B, P, npad)
  const int4 v = reinterpret_cast<const int4*>(rows)[row_id * 32 + lane];

  // ---- expected key of the probe, from q_cap * inv_vs ----
  float e[3];
  const int pk_exp = expected_key(qc, inv, off, signed_probe, e);

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
    const int* table, const float* voxel_size, const float* inv_voxel_size, const int* epoch,
    const float* q, const unsigned char* valid, int* rows_out, float* cx, float* cy, float* cz,
    float* cm, int B, int N, int npad, int P, int neighbors, int K, int stride, int n_buckets,
    int has_valid, void* stream) {
  const int per_block = 32 * kGatherWarps;
  static bool carveout_set = false;  // once: the launch itself stays capturable in a CUDA graph
  if (!carveout_set) {
    const cudaError_t e = cudaFuncSetAttribute(capture_gather_kernel,
                                               cudaFuncAttributePreferredSharedMemoryCarveout,
                                               (int)cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return (int)e;
    carveout_set = true;
  }
  const dim3 grid((unsigned)((npad + per_block - 1) / per_block), (unsigned)P, (unsigned)B);
  capture_gather_kernel<<<grid, per_block, 0, (cudaStream_t)stream>>>(
      table, voxel_size, inv_voxel_size, epoch, q, valid, rows_out, cx, cy, cz, cm, N, npad, P,
      neighbors, K, stride, 128 / stride, n_buckets, has_valid);
  return (int)cudaGetLastError();
}

extern "C" int reselect_launch(
    const int* rows, const float* voxel_size, const float* inv_voxel_size, const int* epoch,
    const float* q_live, const float* q_cap, const unsigned char* valid, float* cx, float* cy,
    float* cz, float* cm, int B, int N, int npad, int P, int neighbors, int K, int stride,
    int has_valid, void* stream) {
  const long long warps = (long long)B * P * npad;
  const int threads = 256;
  const long long blocks = (warps * 32 + threads - 1) / threads;
  reselect_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      rows, voxel_size, inv_voxel_size, epoch, q_live, q_cap, valid, cx, cy, cz, cm, B, N, npad,
      P, neighbors, K, stride, has_valid);
  return (int)cudaGetLastError();
}
