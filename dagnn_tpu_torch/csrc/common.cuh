// Device helpers shared by the port's CUDA sources (wavefront.cu, the row
// and pair kernels K1-K5; segment_attn.cu, the edge-softmax aggregate K6):
// typed loads and stores in float32, rounding through the compute type, a
// warp sum, and an ordered per-slot edge list scanned from device memory
// (wavefront.cu's attn_bwd; the other segment ops stage their keys in
// shared memory first).
// ops/build.py hashes this header with each source that includes it.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <float.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float ldf(const float* p) { return *p; }
__device__ __forceinline__ float ldf(const bf16* p) { return __bfloat162float(*p); }

template <typename T> __device__ __forceinline__ T cvt(float x);
template <> __device__ __forceinline__ float cvt<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 cvt<bf16>(float x) { return __float2bfloat16_rn(x); }

// round through the compute type (identity at float32)
template <typename T> __device__ __forceinline__ float rnd(float x);
template <> __device__ __forceinline__ float rnd<float>(float x) { return x; }
template <> __device__ __forceinline__ float rnd<bf16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Warp 0 only: ascending list of e in [0, ne) with idx[e] == n and mask[e] > 0.
// The ballots keep the edges' order, so every sum over the list runs in a
// fixed order and a run is bitwise repeatable.
__device__ __forceinline__ int build_list(const int* idx, const float* mask, int ne, int n,
                                          int* lst) {
  const int lane = threadIdx.x & 31;
  int cnt = 0;
  for (int base = 0; base < ne; base += 32) {
    const int e = base + lane;
    const bool p = e < ne && idx[e] == n && mask[e] > 0.f;
    const unsigned m = __ballot_sync(0xffffffffu, p);
    if (p) lst[cnt + __popc(m & ((1u << lane) - 1u))] = e;
    cnt += __popc(m);
  }
  return cnt;
}

// dynamic shared memory that takes a block (with its static part, stat
// bytes) above the 48 KB default needs an opt-in
template <typename K>
static void smem_opt_in(K kernel, size_t bytes, size_t stat = 0) {
  if (bytes + stat > 48 * 1024)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}
