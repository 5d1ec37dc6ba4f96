// Kernel B4: fused nearest-candidate selection for the generic ICP loop.
//
// Replaces mola_lidar_odometry_tpu/ops/pallas_match.py::nn_select
// (pallas_call at :109, body _nn_kernel at :66-83).
//
// For every (instance, query): the squared distance to each of its C cached
// candidates, masked candidates set to 3.4e38, the row minimum, the FIRST
// candidate that attains it, and that candidate's coordinates.  A query with
// no live candidate returns d2min = 3.4e38 (not inf) and candidate 0's
// coordinates, masked or not: every candidate ties at 3.4e38 and the lowest
// index wins.
//
// The TPU kernel's 128-query tiles and its padding of C and N to 128 are
// layout, not semantics: this kernel takes any N and any C.  One warp
// handles one query; its lanes stride over the C candidates of the four
// (B, N, C) planes (neighbouring lanes read neighbouring words), each lane
// keeps its own first minimum, and one shuffle butterfly on (d2, candidate
// index) with the lower index winning ties gives every lane the winner.
// Lane 0 reads the winner's coordinates and writes one 16-byte row
// (x, y, z, d2min).  The TPU kernel extracts the winner with a one-hot sum;
// for finite planes that sum equals a direct read, except that it turns
// -0.0 into +0.0, which the "+ 0.0f" below reproduces.
//
// Bound: bytes.  Each candidate costs 16 B of plane reads against 9 flops,
// so the least time is (B*N*(16*C + 12 + 16)) bytes over the memory rate.
// This file is built with -fmad=false and spells the distance with __f*_rn
// intrinsics in the order (dx*dx + dy*dy) + dz*dz, so the output equals the
// plain PyTorch twin's bit for bit.

#include <cuda_runtime.h>
#include <limits.h>

namespace {

constexpr float kBig = 3.4e38f;
constexpr unsigned kFull = 0xffffffffu;

__global__ void nn_select_kernel(
    const float* __restrict__ q,   // (Q, 3) queries, Q = B*N
    const float* __restrict__ cx, const float* __restrict__ cy, const float* __restrict__ cz,
    const float* __restrict__ cm,  // (Q, C) planes; mask is 0/1
    float* __restrict__ out,       // (Q, 4): x, y, z, d2min
    long long Q, int C) {
  const int lane = threadIdx.x & 31;
  const long long w = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (w >= Q) return;  // uniform per warp
  const float qx = q[w * 3], qy = q[w * 3 + 1], qz = q[w * 3 + 2];
  const long long base = w * C;

  // this lane's first minimum over c = lane, lane + 32, ...
  float d = kBig;
  int k = lane < C ? lane : INT_MAX;
  for (int c = lane; c < C; c += 32) {
    const float dx = __fsub_rn(cx[base + c], qx);
    const float dy = __fsub_rn(cy[base + c], qy);
    const float dz = __fsub_rn(cz[base + c], qz);
    float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
    d2 = cm[base + c] > 0.f ? d2 : kBig;
    if (d2 < d) { d = d2; k = c; }  // strict: the earlier candidate keeps a tie
  }
  // warp argmin over (d, k), the lower candidate index winning ties
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float od = __shfl_xor_sync(kFull, d, off);
    const int ok = __shfl_xor_sync(kFull, k, off);
    if (od < d || (od == d && ok < k)) { d = od; k = ok; }
  }
  if (lane == 0) {
    float4 r;
    r.x = __fadd_rn(cx[base + k], 0.0f);
    r.y = __fadd_rn(cy[base + k], 0.0f);
    r.z = __fadd_rn(cz[base + k], 0.0f);
    r.w = d;
    reinterpret_cast<float4*>(out)[w] = r;
  }
}

}  // namespace

extern "C" int nn_select_launch(
    const float* q, const float* cx, const float* cy, const float* cz, const float* cm,
    float* out, long long Q, int C, void* stream) {
  const int threads = 256;  // 8 queries per block
  const long long blocks = (Q * 32 + threads - 1) / threads;
  nn_select_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      q, cx, cy, cz, cm, out, Q, C);
  return (int)cudaGetLastError();
}
