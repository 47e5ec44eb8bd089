// K6 for Hopper (sm_90a): the edge-softmax aggregate of the per-direction
// wavefront's generic branch (segment_impl="pallas"), forward and backward.
//
// Replaces dagnn_tpu/ops/pallas/segment_attn.py pallas_edge_softmax_aggregate:
// the forward kernel `_kernel` (one-hot P, masked column max, exp, P^T e,
// P^T (alpha * values)) and its backward `_bwd` (dense JAX, recomputing
// alpha from the scores). Per destination slot s of S:
//   alpha_e  = exp(score_e - max_s) / (sum_s exp(score - max_s) + 1e-16)
//   out[s]   = sum_e alpha_e values[e]
// over the edges e with dst[e] == s and mask[e] set, everything in float32,
// the output rounded to the values' type. Backward, with g = d out:
//   d_values[e] = alpha_e g[s]
//   d_alpha_e   = <g[s], values[e]>
//   d_scores_e  = alpha_e (d_alpha_e - sum_s alpha d_alpha)
// and zero grads for every edge outside a slot (masked, or dst >= S).
//
// Translation: no one-hot matrices. One thread block per slot builds the
// slot's ascending edge list with warp ballots (build_list), then thread 0
// takes the max, exponentials and sum in edge order, and the columns of the
// weighted sum run across the block's threads. No atomics: every sum has a
// fixed order, so runs are bitwise repeatable. A masked edge never reaches
// exp(): the TPU kernel multiplies exp(score - 0) by the mask, which turns a
// score above ~88 into inf * 0 = NaN and spreads it through its matmuls.
//
// What bounds it on an H100 at the flagship level (Ke 512, S 257, H 300,
// bf16): the forward reads about 0.31 MB of values and writes 0.15 MB, the
// backward about 0.8 MB; a few hundred thousand flops each. Both are memory
// bound on paper (0.14 and 0.23 us at 3.35 TB/s). Measured on an H100
// (chip_smoke.py phase 3c, device time from a CUDA graph): 7.4 us forward,
// 9.6 us backward, so the serial parts set the time: warp 0 scans all Ke
// edges in 16 ballot steps for every slot, and thread 0 runs the slot's
// softmax alone (at most 6 edges a slot there). An eager call from Python
// takes about 20 us, so on the wavefront the host's issue rate, not the
// kernel, sets the pace. Staging dst / mask in shared memory with the whole
// block, or one warp per slot, is the next step for the kernel itself.

#include "common.cuh"

#define NT_SA 128

// Thread 0 only: alpha of the slot's m listed edges, in list order.
template <typename T>
__device__ __forceinline__ void slot_softmax(const T* scores, const int* lst, int m,
                                             float* al) {
  float mx = -FLT_MAX;
  for (int j = 0; j < m; ++j) {
    al[j] = ldf(scores + lst[j]);
    mx = fmaxf(mx, al[j]);
  }
  if (mx <= -FLT_MAX) mx = 0.f;
  float den = 0.f;
  for (int j = 0; j < m; ++j) {
    al[j] = expf(al[j] - mx);
    den += al[j];
  }
  const float dd = den + 1e-16f;
  for (int j = 0; j < m; ++j) al[j] = al[j] / dd;
}

// grid (S), block NT_SA. Dynamic shared memory: Ke edge ids, Ke alphas.
template <typename T>
__global__ void __launch_bounds__(NT_SA) sa_fwd_kernel(int Ke, int H, const T* scores,
                                                       const T* values, const int* dst,
                                                       const float* mask, T* out) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* lst = reinterpret_cast<int*>(smem);
  float* al = reinterpret_cast<float*>(lst + Ke);
  __shared__ int s_cnt;
  const int s = blockIdx.x;
  if ((threadIdx.x >> 5) == 0) {
    const int c = build_list(dst, mask, Ke, s, lst);
    if ((threadIdx.x & 31) == 0) s_cnt = c;
  }
  __syncthreads();
  const int m = s_cnt;
  if (threadIdx.x == 0) slot_softmax<T>(scores, lst, m, al);
  __syncthreads();
  for (int h = threadIdx.x; h < H; h += blockDim.x) {
    float acc = 0.f;
    for (int j = 0; j < m; ++j) acc += al[j] * ldf(values + (size_t)lst[j] * H + h);
    out[(size_t)s * H + h] = cvt<T>(acc);
  }
}

// grid (S), block NT_SA. Dynamic shared memory: Ke edge ids, Ke alphas, Ke
// d_alphas. The zero grads of edges outside every slot are written by all
// blocks (edge e by block e mod S, its columns across threads, coalesced).
template <typename T>
__global__ void __launch_bounds__(NT_SA) sa_bwd_kernel(int Ke, int H, const T* scores,
                                                       const T* values, const int* dst,
                                                       const float* mask, const T* g,
                                                       T* dscores, T* dvalues) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* lst = reinterpret_cast<int*>(smem);
  float* al = reinterpret_cast<float*>(lst + Ke);
  float* dal = al + Ke;
  __shared__ int s_cnt;
  const int s = blockIdx.x, S = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nw = blockDim.x >> 5;
  for (int e = s; e < Ke; e += S) {
    const int d = dst[e];
    if (mask[e] > 0.f && d >= 0 && d < S) continue;
    for (int h = tid; h < H; h += blockDim.x) dvalues[(size_t)e * H + h] = cvt<T>(0.f);
    if (tid == 0) dscores[e] = cvt<T>(0.f);
  }
  if (warp == 0) {
    const int c = build_list(dst, mask, Ke, s, lst);
    if (lane == 0) s_cnt = c;
  }
  __syncthreads();
  const int m = s_cnt;
  if (tid == 0) slot_softmax<T>(scores, lst, m, al);
  __syncthreads();
  const T* gs = g + (size_t)s * H;
  for (int j = warp; j < m; j += nw) {
    const T* v = values + (size_t)lst[j] * H;
    float acc = 0.f;
    for (int h = lane; h < H; h += 32) acc += ldf(gs + h) * ldf(v + h);
    acc = warp_sum(acc);
    if (lane == 0) dal[j] = acc;
  }
  for (int h = tid; h < H; h += blockDim.x) {
    const float gh = ldf(gs + h);
    for (int j = 0; j < m; ++j) dvalues[(size_t)lst[j] * H + h] = cvt<T>(al[j] * gh);
  }
  __syncthreads();
  if (tid == 0) {
    float sd = 0.f;
    for (int j = 0; j < m; ++j) sd += al[j] * dal[j];
    for (int j = 0; j < m; ++j) dscores[lst[j]] = cvt<T>(al[j] * (dal[j] - sd));
  }
}

// ------------------------------------------------------------ C interface
// dtype: 0 float32, 1 bfloat16 (scores, values, g and the grads share it);
// dst int32 [Ke], mask float32 [Ke]. Every entry returns cudaGetLastError(),
// or cudaErrorInvalidValue for shapes it cannot run.

#define P(T, x) static_cast<const T*>(x)
#define PM(T, x) static_cast<T*>(x)

template <typename T>
static void launch_fwd(int Ke, int S, int H, const void* scores, const void* values,
                       const int* dst, const float* mask, void* out, cudaStream_t st) {
  const size_t smem = (size_t)Ke * (sizeof(int) + sizeof(float));
  smem_opt_in(sa_fwd_kernel<T>, smem);
  sa_fwd_kernel<T><<<S, NT_SA, smem, st>>>(Ke, H, P(T, scores), P(T, values), dst, mask,
                                           PM(T, out));
}

extern "C" int sa_forward(int dtype, int Ke, int S, int H, const void* scores,
                          const void* values, const int* dst, const float* mask, void* out,
                          void* stream) {
  if (S < 1 || Ke < 0 || H < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) launch_fwd<float>(Ke, S, H, scores, values, dst, mask, out, st);
  else launch_fwd<bf16>(Ke, S, H, scores, values, dst, mask, out, st);
  return (int)cudaGetLastError();
}

template <typename T>
static void launch_bwd(int Ke, int S, int H, const void* scores, const void* values,
                       const int* dst, const float* mask, const void* g, void* dscores,
                       void* dvalues, cudaStream_t st) {
  const size_t smem = (size_t)Ke * (sizeof(int) + 2 * sizeof(float));
  smem_opt_in(sa_bwd_kernel<T>, smem);
  sa_bwd_kernel<T><<<S, NT_SA, smem, st>>>(Ke, H, P(T, scores), P(T, values), dst, mask,
                                           P(T, g), PM(T, dscores), PM(T, dvalues));
}

extern "C" int sa_backward(int dtype, int Ke, int S, int H, const void* scores,
                           const void* values, const int* dst, const float* mask,
                           const void* g, void* dscores, void* dvalues, void* stream) {
  if (S < 1 || Ke < 0 || H < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    launch_bwd<float>(Ke, S, H, scores, values, dst, mask, g, dscores, dvalues, st);
  else
    launch_bwd<bf16>(Ke, S, H, scores, values, dst, mask, g, dscores, dvalues, st);
  return (int)cudaGetLastError();
}
