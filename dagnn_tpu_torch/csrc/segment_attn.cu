// K6 for Hopper (sm_90a): the edge-softmax aggregate of the per-direction
// wavefront's generic branch (segment_impl="pallas"), forward and backward.
//
// Replaces dagnn_tpu/ops/pallas/segment_attn.py pallas_edge_softmax_aggregate:
// sa_fwd_kernel its forward `_kernel` (:30, called through pallas_call at
// :64: one-hot P, masked column max, exp, P^T e, P^T (alpha * values)),
// sa_bwd_kernel its backward `_bwd` (:94, dense JAX, recomputing alpha from
// the scores). Per destination slot s of S:
//   alpha_e  = exp(score_e - max_s) / (sum_s exp(score - max_s) + 1e-16)
//   out[s]   = sum_e alpha_e values[e]
// over the edges e with dst[e] == s and mask[e] set, everything in float32,
// the output rounded to the values' type. Backward, with g = d out:
//   d_values[e] = alpha_e g[s]
//   d_alpha_e   = <g[s], values[e]>
//   d_scores_e  = alpha_e (d_alpha_e - sum_s alpha d_alpha)
// and zero grads for every edge outside a slot (masked, or dst outside
// [0, S)). A masked edge never reaches exp(): the TPU kernel multiplies
// exp(score - 0) by the mask, which turns a score above ~88 into
// inf * 0 = NaN and spreads it through its matmuls.
//
// What bounds it on an H100 at the flagship level (Ke 512, S 257, H 300,
// bf16): the forward moves 0.467 MB and the backward 0.775 MB (0.14 and
// 0.23 us at 3.35 TB/s), with at most 2 (forward schedule) or 11 (reverse)
// edges a slot. So the time is a latency chain, not bytes: the launch's
// fixed cost, then the dependent device reads of a slot (its edge list,
// then its value rows); the design keeps every other step of the chain
// in registers and shared memory, with no single-thread section.
//
// Design. One warp a slot, SA_WARPS slots a block. The block stages dst,
// mask and the scores in shared memory, SA_CHUNK entries at a time
// (16-byte loads where the pointers allow): key = dst where the edge
// counts, else -1, and the score in f32; so shared memory does not depend
// on Ke. Each warp lists its slot's edges in ascending order by ballots
// over the staged keys, four entries a lane a step, into its own list of
// (edge, score), taking the max on the way. The softmax stays in the warp:
// the denominator is a shuffle sum a round of up to 32 listed edges (lane
// j holds edge j), rounds added in ascending order; there is no
// single-thread section and no block barrier after the staging. The
// weighted sum (and in the backward the dot products <g, v_e> and the rows
// alpha_e g) reads 8 bytes of a row a lane (4 bf16 or 2 f32; one element
// where H or a pointer does not allow it), SA_U listed rows in flight at
// once, each column's sum over the edges in ascending order. The backward
// loads g[s] before the staging and keeps it in registers, and zeroes the
// dead edges' grads from the staged keys, spread over every warp of the
// grid, with the same wide stores. A list longer than SA_LCAP is not kept:
// its warp rescans the staged keys in each later pass, in the same order
// (above SA_CHUNK edges a level the block restages the chunks), so no slot
// has a cap on its edges. No atomics: every sum has a fixed order, and two
// launches agree bit for bit. 2 and 8 warps a block, 2 warps a slot
// splitting its columns, and 8 rows in flight were each slower in bf16 on
// the H100.
//
// Measured (chip_smoke.py phase 3c, device time from a CUDA graph, NVIDIA
// H100 80GB HBM3, 700.00 W, bf16): forward 3.6 us at the busiest flagship
// level (512 valid edges, at most 6 a slot) and 3.3 us at the median one
// (383, at most 2), backward 5.1 and 4.3 us; a block a slot scanning its
// list from device memory, 7.5 and 9.8 us at the busiest level in the same
// run. What is left is the launch's fixed cost and two dependent device
// reads a slot (the staged indices, then the value rows); see PERF.md.

#include "common.cuh"

#define SA_WARPS 4      // warps a block, a slot each
#define SA_CHUNK 2048   // dst / mask / score entries staged at a time
#define SA_LCAP 256     // a warp's list of (edge, score); a longer one is rescanned
#define SA_U 4          // listed rows loaded together
#define SA_COLS 384     // columns a warp holds in registers at a time

static_assert(SA_CHUNK % 128 == 0 && SA_LCAP >= 128 + 32, "128 entries a ballot step");

struct SaShared {
  int key[SA_CHUNK];            // dst where the edge counts, else -1
  float sc[SA_CHUNK];           // its score in f32
  int le[SA_WARPS][SA_LCAP];    // each warp's listed edges, ascending
  float ls[SA_WARPS][SA_LCAP];  // and their scores
};

// V consecutive elements of a row as f32, and back: 8 bytes (4 bf16 or 2
// f32) at V > 1, one element at V = 1.
template <typename T, int V>
__device__ __forceinline__ void ld_cols(const T* p, float* o) {
  static_assert(V == 1 || V * sizeof(T) == 8, "8-byte columns");
  if constexpr (V == 1) {
    o[0] = ldf(p);
  } else if constexpr (sizeof(T) == 2) {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.y));
    o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
  } else {
    const float2 q = *reinterpret_cast<const float2*>(p);
    o[0] = q.x; o[1] = q.y;
  }
}
template <typename T, int V>
__device__ __forceinline__ void st_cols(T* p, const float* v) {
  if constexpr (V == 1) {
    p[0] = cvt<T>(v[0]);
  } else if constexpr (sizeof(T) == 2) {
    const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
    *reinterpret_cast<uint2*>(p) = make_uint2(*reinterpret_cast<const uint32_t*>(&a),
                                              *reinterpret_cast<const uint32_t*>(&b));
  } else {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  }
}

// four consecutive scores as f32 (8 bytes of bf16, 16 of f32)
__device__ __forceinline__ float4 ld4(const bf16* p) {
  float o[4];
  ld_cols<bf16, 4>(p, o);
  return make_float4(o[0], o[1], o[2], o[3]);
}
__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }

__device__ __forceinline__ int sa_key(int d, float m, int S) {
  return m > 0.f && d >= 0 && d < S ? d : -1;
}

// The whole block: entries [e0, e0 + ne) into sm.key / sm.sc, and key -1 up
// to the next multiple of 128 (a ballot step's entries).
template <typename T>
__device__ __forceinline__ void sa_stage(SaShared& sm, const T* scores, const int* dst,
                                         const float* mask, int e0, int ne, int S) {
  scores += e0;
  dst += e0;
  mask += e0;
  int done = 0;
  if (((reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(mask)) & 15) == 0 &&
      (reinterpret_cast<uintptr_t>(scores) & (4 * sizeof(T) - 1)) == 0) {
    done = ne & ~3;
    for (int i = threadIdx.x; i < (ne >> 2); i += blockDim.x) {
      const int4 d = reinterpret_cast<const int4*>(dst)[i];
      const float4 m = reinterpret_cast<const float4*>(mask)[i];
      const float4 s = ld4(scores + 4 * i);
      reinterpret_cast<int4*>(sm.key)[i] = make_int4(sa_key(d.x, m.x, S), sa_key(d.y, m.y, S),
                                                     sa_key(d.z, m.z, S), sa_key(d.w, m.w, S));
      reinterpret_cast<float4*>(sm.sc)[i] = s;
    }
  }
  for (int i = done + threadIdx.x; i < ne; i += blockDim.x) {
    sm.key[i] = sa_key(dst[i], mask[i], S);
    sm.sc[i] = ldf(scores + i);
  }
  for (int i = ne + threadIdx.x; i < ((ne + 127) & ~127); i += blockDim.x) sm.key[i] = -1;
}

// One warp, one ballot step: the staged entries [b, b + 128) whose key is
// n, appended in ascending order to the warp's list at cnt (edge ids offset
// by e0, with their scores; mx takes their max). Lane l tests entries
// b + 4l .. b + 4l + 3. Returns how many.
__device__ __forceinline__ int sa_ballot(const SaShared& sm, int b, int n, int e0, int* le,
                                         float* ls, int cnt, float& mx) {
  const int lane = threadIdx.x & 31;
  const int4 k = reinterpret_cast<const int4*>(sm.key + b)[lane];
  const bool h[4] = {k.x == n, k.y == n, k.z == n, k.w == n};
  const unsigned lt = (1u << lane) - 1u;
  int r = cnt, tot = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const unsigned bl = __ballot_sync(0xffffffffu, h[q]);
    r += __popc(bl & lt);
    tot += __popc(bl);
  }
#pragma unroll
  for (int q = 0; q < 4; ++q)
    if (h[q]) {
      const int e = b + 4 * lane + q;
      const float s = sm.sc[e];
      le[r] = e0 + e;
      ls[r] = s;
      mx = fmaxf(mx, s);
      ++r;
    }
  return tot;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// A warp's slot: its place in the grid, the list pass A built, and the
// rounds of up to 32 listed edges every later pass walks in ascending order.
template <typename T>
struct SaSlot {
  SaShared& sm;
  const T* scores;
  const int* dst;
  const float* mask;
  int Ke, S, n, nch, m;
  bool live, rescan;
  int* le;
  float* ls;
  float mx;

  __device__ __forceinline__ SaSlot(SaShared& sm_, const T* scores_, const int* dst_,
                                    const float* mask_, int Ke_, int S_)
      : sm(sm_), scores(scores_), dst(dst_), mask(mask_), Ke(Ke_), S(S_) {
    const int warp = threadIdx.x >> 5;
    n = blockIdx.x * SA_WARPS + warp;
    live = n < S;
    nch = (Ke + SA_CHUNK - 1) / SA_CHUNK;
    le = sm.le[warp];
    ls = sm.ls[warp];
  }

  // A branch every warp of the block takes alike when the passes restage
  // (more than one chunk); with one chunk each warp decides for itself.
  __device__ __forceinline__ bool uniform(bool p) const { return nch > 1 ? __syncthreads_or(p) : p; }

  // Pass A: stage each chunk (dead(e0, ne) runs on it, every warp), list
  // the slot's edges and their max. A list that outgrows SA_LCAP is dropped
  // and later passes rescan.
  template <typename Dead>
  __device__ __forceinline__ void list(Dead&& dead) {
    int cnt = 0;
    bool over = false;
    m = 0;
    mx = -FLT_MAX;
    for (int ch = 0; ch < nch; ++ch) {
      const int e0 = ch * SA_CHUNK, ne = min(SA_CHUNK, Ke - e0);
      __syncthreads();                      // every warp is done with the last chunk
      sa_stage(sm, scores, dst, mask, e0, ne, S);
      __syncthreads();
      dead(e0, ne);
      if (!live) continue;
      for (int b = 0; b < ne; b += 128) {
        if (cnt > SA_LCAP - 128) {
          over = true;
          cnt = 0;
        }
        const int t = sa_ballot(sm, b, n, e0, le, ls, cnt, mx);
        cnt += t;
        m += t;
      }
    }
    mx = warp_max(mx);
    if (mx <= -FLT_MAX) mx = 0.f;
    rescan = uniform(over);
    __syncwarp();
  }

  // f(e, s, c) for each round of c <= 32 listed edges, in ascending order:
  // lane j holds the round's j-th edge e and its score s (e = -1 past c).
  template <typename F>
  __device__ __forceinline__ void rounds(F&& f) {
    const int lane = threadIdx.x & 31;
    if (!rescan) {
      for (int r0 = 0; r0 < m; r0 += 32) {
        const int j = r0 + lane;
        f(j < m ? le[j] : -1, j < m ? ls[j] : 0.f, min(32, m - r0));
      }
      return;
    }
    int cnt = 0;
    auto flush = [&]() {
      __syncwarp();
      for (int r0 = 0; r0 < cnt; r0 += 32) {
        const int j = r0 + lane;
        f(j < cnt ? le[j] : -1, j < cnt ? ls[j] : 0.f, min(32, cnt - r0));
      }
      __syncwarp();
      cnt = 0;
    };
    for (int ch = 0; ch < nch; ++ch) {
      const int e0 = ch * SA_CHUNK, ne = min(SA_CHUNK, Ke - e0);
      if (nch > 1) {
        __syncthreads();
        sa_stage(sm, scores, dst, mask, e0, ne, S);
        __syncthreads();
      }
      if (!live) continue;
      for (int b = 0; b < ne; b += 128) {
        if (cnt > SA_LCAP - 128) flush();
        float unused = 0.f;
        cnt += sa_ballot(sm, b, n, e0, le, ls, cnt, unused);
      }
    }
    if (live) flush();
  }

  // sum over the slot's edges of exp(score - max) + 1e-16: a shuffle sum a
  // round, rounds in ascending order
  __device__ __forceinline__ float denominator() {
    float den = 0.f;
    rounds([&](int e, float s, int) { den += warp_sum(e >= 0 ? expf(s - mx) : 0.f); });
    return den + 1e-16f;
  }
};

// Lanes u0 .. u0 + SA_U - 1 of the round (edge, alpha) to every lane; -1
// past the round's c edges.
__device__ __forceinline__ void sa_bcast(int e, float a, int u0, int c, int* eu, float* au) {
#pragma unroll
  for (int u = 0; u < SA_U; ++u) {
    const int x = __shfl_sync(0xffffffffu, e, (u0 + u) & 31);
    au[u] = __shfl_sync(0xffffffffu, a, (u0 + u) & 31);
    eu[u] = u0 + u < c ? x : -1;
  }
}

// grid ceil(S / SA_WARPS), block SA_WARPS * 32; static shared
// memory only (SaShared).
template <typename T, int V>
__global__ void __launch_bounds__(SA_WARPS * 32) sa_fwd_kernel(int Ke, int S, int H,
                                                               const T* scores, const T* values,
                                                               const int* dst, const float* mask,
                                                               T* out) {
  __shared__ __align__(16) SaShared sm;
  constexpr int CG = SA_COLS / (32 * V);   // column groups a pass
  constexpr int PW = CG * 32 * V;           // columns a pass
  const int lane = threadIdx.x & 31;
  SaSlot<T> sl(sm, scores, dst, mask, Ke, S);
  sl.list([](int, int) {});
  const float dd = sl.denominator();
  for (int c0 = 0; c0 < H; c0 += PW) {
    float acc[CG][V];
#pragma unroll
    for (int k = 0; k < CG; ++k)
#pragma unroll
      for (int i = 0; i < V; ++i) acc[k][i] = 0.f;
    sl.rounds([&](int e, float s, int c) {
      const float a = e >= 0 ? expf(s - sl.mx) / dd : 0.f;
      for (int u0 = 0; u0 < c; u0 += SA_U) {
        int eu[SA_U];
        float au[SA_U], x[SA_U][CG][V];
        sa_bcast(e, a, u0, c, eu, au);
#pragma unroll
        for (int u = 0; u < SA_U; ++u)
#pragma unroll
          for (int k = 0; k < CG; ++k) {
            const int col = c0 + (k * 32 + lane) * V;
            if (eu[u] >= 0 && col < H) ld_cols<T, V>(values + (size_t)eu[u] * H + col, x[u][k]);
          }
#pragma unroll
        for (int u = 0; u < SA_U; ++u)
#pragma unroll
          for (int k = 0; k < CG; ++k) {
            const int col = c0 + (k * 32 + lane) * V;
            if (eu[u] >= 0 && col < H)
#pragma unroll
              for (int i = 0; i < V; ++i) acc[k][i] += au[u] * x[u][k][i];
          }
      }
    });
    if (!sl.live) continue;
#pragma unroll
    for (int k = 0; k < CG; ++k) {
      const int col = c0 + (k * 32 + lane) * V;
      if (col < H) st_cols<T, V>(out + (size_t)sl.n * H + col, acc[k]);
    }
  }
}

// grid and block as sa_fwd_kernel. The dead edges' zero grads: staged edge
// e of a chunk by the grid's warp e mod (gridDim.x * SA_WARPS).
template <typename T, int V>
__global__ void __launch_bounds__(SA_WARPS * 32) sa_bwd_kernel(int Ke, int S, int H,
                                                               const T* scores, const T* values,
                                                               const int* dst, const float* mask,
                                                               const T* g, T* dscores,
                                                               T* dvalues) {
  __shared__ __align__(16) SaShared sm;
  constexpr int CG = SA_COLS / (32 * V);
  constexpr int PW = CG * 32 * V;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int npass = (H + PW - 1) / PW;
  SaSlot<T> sl(sm, scores, dst, mask, Ke, S);
  float gs[CG][V];                          // g[s]'s columns of a pass
  auto load_g = [&](int c0) {
#pragma unroll
    for (int k = 0; k < CG; ++k) {
      const int col = c0 + (k * 32 + lane) * V;
#pragma unroll
      for (int i = 0; i < V; ++i) gs[k][i] = 0.f;
      if (sl.live && col < H) ld_cols<T, V>(g + (size_t)sl.n * H + col, gs[k]);
    }
  };
  if (npass == 1) load_g(0);                // before the staging when one pass holds them
  const int nwarps = gridDim.x * SA_WARPS, gw = blockIdx.x * SA_WARPS + warp;
  sl.list([&](int e0, int ne) {
    for (int e = gw; e < ne; e += nwarps) {
      if (sm.key[e] >= 0) continue;
      const size_t r = (size_t)(e0 + e) * H;
      const float z[V] = {};
      for (int col = lane * V; col < H; col += 32 * V) st_cols<T, V>(dvalues + r + col, z);
      if (lane == 0) dscores[e0 + e] = cvt<T>(0.f);
    }
  });
  const float dd = sl.denominator();
  const bool single = sl.m <= 32;           // one round: d_scores need no second pass
  float sd = 0.f;                           // sum of alpha d_alpha, rounds ascending
  // first: store d_values and add to sd; else (or single) store d_scores
  auto round = [&](int e, float s, int c, bool first) {
    const float a = e >= 0 ? expf(s - sl.mx) / dd : 0.f;
    float dal = 0.f;                        // lane j: d_alpha of the round's edge j
    for (int u0 = 0; u0 < c; u0 += SA_U) {
      int eu[SA_U];
      float au[SA_U], dp[SA_U];
      sa_bcast(e, a, u0, c, eu, au);
#pragma unroll
      for (int u = 0; u < SA_U; ++u) dp[u] = 0.f;
      for (int c0 = 0; c0 < H; c0 += PW) {
        float x[SA_U][CG][V];
        if (npass > 1) load_g(c0);
#pragma unroll
        for (int u = 0; u < SA_U; ++u)
#pragma unroll
          for (int k = 0; k < CG; ++k) {
            const int col = c0 + (k * 32 + lane) * V;
            if (eu[u] >= 0 && col < H) ld_cols<T, V>(values + (size_t)eu[u] * H + col, x[u][k]);
          }
#pragma unroll
        for (int u = 0; u < SA_U; ++u)
#pragma unroll
          for (int k = 0; k < CG; ++k) {
            const int col = c0 + (k * 32 + lane) * V;
            if (eu[u] < 0 || col >= H) continue;
#pragma unroll
            for (int i = 0; i < V; ++i) dp[u] += gs[k][i] * x[u][k][i];
            if (first) {
              float o[V];
#pragma unroll
              for (int i = 0; i < V; ++i) o[i] = au[u] * gs[k][i];
              st_cols<T, V>(dvalues + (size_t)eu[u] * H + col, o);
            }
          }
      }
#pragma unroll
      for (int u = 0; u < SA_U; ++u) dp[u] = warp_sum(dp[u]);
#pragma unroll
      for (int u = 0; u < SA_U; ++u)
        if (lane == u0 + u) dal = dp[u];
    }
    if (first) sd += warp_sum(a * dal);
    if ((!first || single) && e >= 0) dscores[e] = cvt<T>(a * (dal - sd));
  };
  sl.rounds([&](int e, float s, int c) { round(e, s, c, true); });
  if (sl.uniform(!single))                  // d_scores once sd is whole: d_alpha again
    sl.rounds([&](int e, float s, int c) {
      if (!single) round(e, s, c, false);
    });
}

// ------------------------------------------------------------ C interface
// dtype: 0 float32, 1 bfloat16 (scores, values, g and the grads share it);
// dst int32 [Ke], mask float32 [Ke]. Every entry returns cudaGetLastError(),
// or cudaErrorInvalidValue for shapes it cannot run.

#define P(T, x) static_cast<const T*>(x)
#define PM(T, x) static_cast<T*>(x)

// 8-byte columns when a row's bytes and every row pointer allow them
template <typename T>
static bool wide(int H, const void* a, const void* b, const void* c = nullptr) {
  return (H * sizeof(T)) % 8 == 0 &&
         ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
           reinterpret_cast<uintptr_t>(c)) & 7) == 0;
}

static dim3 sa_grid(int S) { return dim3((S + SA_WARPS - 1) / SA_WARPS); }

template <typename T>
static void launch_fwd(int Ke, int S, int H, const void* scores, const void* values,
                       const int* dst, const float* mask, void* out, cudaStream_t st) {
  constexpr int VW = 8 / sizeof(T);
  if (wide<T>(H, values, out))
    sa_fwd_kernel<T, VW><<<sa_grid(S), SA_WARPS * 32, 0, st>>>(
        Ke, S, H, P(T, scores), P(T, values), dst, mask, PM(T, out));
  else
    sa_fwd_kernel<T, 1><<<sa_grid(S), SA_WARPS * 32, 0, st>>>(
        Ke, S, H, P(T, scores), P(T, values), dst, mask, PM(T, out));
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
  constexpr int VW = 8 / sizeof(T);
  if (wide<T>(H, values, g, dvalues))
    sa_bwd_kernel<T, VW><<<sa_grid(S), SA_WARPS * 32, 0, st>>>(
        Ke, S, H, P(T, scores), P(T, values), dst, mask, P(T, g), PM(T, dscores),
        PM(T, dvalues));
  else
    sa_bwd_kernel<T, 1><<<sa_grid(S), SA_WARPS * 32, 0, st>>>(
        Ke, S, H, P(T, scores), P(T, values), dst, mask, P(T, g), PM(T, dscores),
        PM(T, dvalues));
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
