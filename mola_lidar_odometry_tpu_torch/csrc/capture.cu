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
//   * Each thread then reads its own row's way headers and its way's live
//     point words, and selects through select_top2, the code B2 runs too.
//
// B2, reselect_kernel: one thread per (b, p, i), i fastest, on the row B1
//   wrote for that probe.
//   * What bounds it: bytes, but only the bytes its selection needs.  Of the
//     512-byte row it needs the W way headers and the selected way's live
//     point words: the W header sectors (32 bytes each: pkey, state and point
//     words 0-5), plus at most 2 sectors more when K = 20 and stride = 32, so
//     at most 192 bytes.  Its first design (one warp per query, every lane
//     reading 16 bytes of the row, ~40 shuffles and two 5-step butterflies,
//     lane 0 storing 8 scattered floats) read all of every row and was bound
//     by instruction issue.  It now reads scattered 32-byte sectors, one per
//     128-byte way; registers do not limit it (59 or 103 of them, the same
//     time on an H100).
//   * The header pass issues the W sector loads (two int4 each, read-only
//     path) together, and the way is chosen from registers.  The point pass
//     then loads the selected way's further int4 chunks only while they hold
//     a word k < min(cnt, K); a dead probe reads nothing more.
//   * Queries, mask and the 8 output planes are indexed by i across a warp,
//     so their loads and stores are coalesced.  No shuffles.
//   * W = 128 / stride is a template parameter (1, 2 or 4 ways: the strides
//     128, 64 and 32 that VoxelHashMap.create makes), so the headers stay in
//     registers.
//
// select_top2, shared by both kernels: dequantize the selected way's live
// words, take the top-2 in one serial pass equal to two first-min scans (the
// lowest k wins ties; without a live word both picks fall on k = 0, whose
// coordinates are still written), store the four planes.  It holds no
// per-word distances, so B1 and B2 each take 58-59 registers (89 and 103
// with two scans over a K-wide distance array).
//
// Both derive the expected key from floor(q_cap * inv_vs) and select the way
// whose pkey and epoch match (the last matching way wins, way 0 when none
// does).  This file is built with -fmad=false and spells the
// rounding-sensitive arithmetic with __f*_rn intrinsics, so the output
// planes equal the plain PyTorch twin's bit for bit wherever the squared
// distances stay below kBig (every query within 1e19 of its probe voxel).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kBig = 3.4e38f;
constexpr float kInvQ = 1.0f / 1024.0f;

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
constexpr int kChunks = (kMaxK + 2 + 3) / 4;  // int4 chunks of a way's pkey, state and <= 32 point words
constexpr int kReselectThreads = 128;          // B2: queries per block

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

// The top-2 of a probe, shared by B1 and B2.  words[2 + k] is point word k of
// the selected way (words[2] always loaded); the nk words k < nk are its live
// candidates.  Each is dequantized against the probe voxel e and ranked by d2
// to ql in one serial pass that keeps the best and the second best with
// strict compares: the same picks as two first-min scans (the lowest k wins
// ties, the second scan with kBig at the first pick), without holding the K
// distances.  Chunks past the live words are skipped.  Without a live word
// both picks fall on k = 0, whose coordinates are still written.  Both picks
// go to the planes at o1 and o2, their masks times vm.
__device__ __forceinline__ void select_top2(const int (&words)[4 * kChunks], int nk, const float* e, float vs,
                                            const float* ql, float vm, float* __restrict__ cx,
                                            float* __restrict__ cy, float* __restrict__ cz,
                                            float* __restrict__ cm, size_t o1, size_t o2) {
  float d1 = kBig, d2 = kBig;
  int w1 = words[2], w2 = words[2];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    if (4 * c < 2 + nk) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = 4 * c + j - 2;
        if (k >= 0 && k < nk) {
          float xs[3];
          const float d = dequant(words[4 * c + j], e, vs, ql, xs);
          if (d < d1) { d2 = d1; w2 = w1; d1 = d; w1 = words[4 * c + j]; }
          else if (d < d2) { d2 = d; w2 = words[4 * c + j]; }
        }
      }
    }
  }
  float x1[3], x2[3];
  dequant(w1, e, vs, ql, x1);
  dequant(w2, e, vs, ql, x2);
  cx[o1] = x1[0]; cy[o1] = x1[1]; cz[o1] = x1[2]; cm[o1] = (d1 < kBig) ? vm : 0.f;
  cx[o2] = x2[0]; cy[o2] = x2[1]; cz[o2] = x2[2]; cm[o2] = (d2 < kBig) ? vm : 0.f;
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
  const int nk = (any_ok && cnt > 0) ? min(cnt, K) : 0;

  // ---- the way's live point words (16-byte reads), top-2 ----
  const int4* wp = reinterpret_cast<const int4*>(row + wsel * stride);
  int words[4 * kChunks];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    int4 x = make_int4(0, 0, 0, 0);
    if (4 * c < 2 + nk) x = wp[c];
    words[4 * c] = x.x; words[4 * c + 1] = x.y; words[4 * c + 2] = x.z; words[4 * c + 3] = x.w;
  }
  const size_t o1 = (size_t)(b * 2 * P + p) * npad + i;
  select_top2(words, nk, e, vs, ql, (has_valid && !vq) ? 0.f : 1.f, cx, cy, cz, cm, o1, o1 + (size_t)P * npad);
  if (rows_out != nullptr) bulk_store_wait_read();  // the row stays put until the store has read it
}

// grid (ceil(npad / kReselectThreads), P, B), block kReselectThreads; W ways of
// 128 / W words per row
template <int W>
__global__ void __launch_bounds__(kReselectThreads) reselect_kernel(
    const int* __restrict__ rows,  // (B, P, npad, 128), written by B1
    const float* __restrict__ voxel_size, const float* __restrict__ inv_voxel_size,
    const int* __restrict__ epoch, const float* __restrict__ q_live,
    const float* __restrict__ q_cap, const unsigned char* __restrict__ valid,
    float* __restrict__ cx, float* __restrict__ cy, float* __restrict__ cz,
    float* __restrict__ cm, int N, int npad, int P, int neighbors, int K, int has_valid) {
  const int i = blockIdx.x * kReselectThreads + threadIdx.x;
  if (i >= npad) return;
  const int p = blockIdx.y, b = blockIdx.z;

  const bool in_range = i < N;
  float ql[3] = {0.f, 0.f, 0.f}, qc[3] = {0.f, 0.f, 0.f};
  if (in_range) {
    const int qi = (b * N + i) * 3;
    for (int a = 0; a < 3; ++a) { ql[a] = __ldg(q_live + qi + a); qc[a] = __ldg(q_cap + qi + a); }
  }
  const bool vq = in_range && (!has_valid || valid[b * N + i]);
  const float vs = voxel_size[b], inv = inv_voxel_size[b];
  const bool signed_probe = neighbors == 4 || neighbors == 8;
  float off[3];
  probe_offset(neighbors, p, off);
  float e[3];
  const int pk_exp = expected_key(qc, inv, off, signed_probe, e);
  const int e16 = epoch[b] & 0xFFFF;

  // ---- header pass: each way's first 32-byte sector (pkey, state, point
  // words 0-5), all W loads in flight together ----
  constexpr int kWay = 32 / W;  // int4 chunks per way
  const int4* row = reinterpret_cast<const int4*>(rows) + (size_t)((b * P + p) * npad + i) * 32;
  int4 h0[W], h1[W];
#pragma unroll
  for (int w = 0; w < W; ++w) { h0[w] = __ldg(row + w * kWay); h1[w] = __ldg(row + w * kWay + 1); }

  // ---- way select from registers ----
  int wsel = 0;
  bool any_ok = false;
#pragma unroll
  for (int w = 0; w < W; ++w) {
    const bool ok = h0[w].x == pk_exp && ((h0[w].y >> 16) & 0xFFFF) == e16;
    if (ok) wsel = w;
    any_ok = any_ok || ok;
  }
  int words[4 * kChunks];
#pragma unroll
  for (int c = 0; c < 4 * kChunks; ++c) words[c] = 0;
#pragma unroll
  for (int w = 0; w < W; ++w) {
    if (w == wsel) {
      words[0] = h0[w].x; words[1] = h0[w].y; words[2] = h0[w].z; words[3] = h0[w].w;
      words[4] = h1[w].x; words[5] = h1[w].y; words[6] = h1[w].z; words[7] = h1[w].w;
    }
  }
  const int cnt = words[1] & 0xFFFF;
  const int nk = (any_ok && cnt > 0) ? min(cnt, K) : 0;

  // ---- point pass: the selected way's further chunks that hold a word
  // k < nk; a dead probe reads nothing more ----
  const int4* wp = row + wsel * kWay;
#pragma unroll
  for (int c = 2; c < kChunks; ++c) {
    if (4 * c < 2 + nk) {
      const int4 x = __ldg(wp + c);
      words[4 * c] = x.x; words[4 * c + 1] = x.y; words[4 * c + 2] = x.z; words[4 * c + 3] = x.w;
    }
  }
  const size_t o1 = (size_t)(b * 2 * P + p) * npad + i;
  select_top2(words, nk, e, vs, ql, (has_valid && !vq) ? 0.f : 1.f, cx, cy, cz, cm, o1, o1 + (size_t)P * npad);
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
  decltype(&reselect_kernel<4>) kernel = nullptr;
  switch (128 / stride) {
    case 1: kernel = reselect_kernel<1>; break;
    case 2: kernel = reselect_kernel<2>; break;
    case 4: kernel = reselect_kernel<4>; break;
    default: return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((unsigned)((npad + kReselectThreads - 1) / kReselectThreads), (unsigned)P, (unsigned)B);
  kernel<<<grid, kReselectThreads, 0, (cudaStream_t)stream>>>(
      rows, voxel_size, inv_voxel_size, epoch, q_live, q_cap, valid, cx, cy, cz, cm, N, npad, P,
      neighbors, K, has_valid);
  return (int)cudaGetLastError();
}
