// Kernels of the DAGNN wavefront for Hopper (sm_90a): the row kernels
// K1/K2 of the direction-merged and the per-direction fused wavefronts, the
// pair kernels K3/K4 of the pair-scheduled wavefront and the transpose-grad
// accumulate K5 share this device code.
//
// K1 (row forward) replaces dagnn_tpu/ops/pallas/row_step.py
//    fused_row_forward (_row_fwd_kernel, _layer_fwd, _build_P).
// K2 (row backward) replaces row_step.py fused_row_backward
//    (_row_bwd_kernel, _layer_bwd) with use_res=True, merge_tg True or
//    False (False: the cotangent arrives pre-merged by K5, ndirs=1).
// K5 (transpose-grad accumulate) replaces row_step.py _tg_accumulate: the
//    seg_merge kernel launched alone, storing g + the merged sum rounded to
//    g's type. It moves about 1.2 MB a flagship call (Kn 256, Kt 512, L*H
//    600, bf16), 0.37 us at 3.35 TB/s, but what bounds it is each slot's
//    chain of latencies (see seg_merge below: staged keys, a compact list
//    a warp, rows loaded four at once). On an H100 (chip_smoke.py phase 3d,
//    device time from a CUDA graph): 4.4 us against 5.7 us for index_add_
//    on the same data; the first version's block-per-slot scan took 9.8.
// K7 (the near/far layouts, nf) replaces the nf branches of
//    fused_row_forward / fused_row_backward (row_step.py _nf_blocks,
//    _nf_rebuild_vals, the near-grad carry): one row's blocks with ragged
//    per-direction widths; an "r" block's near edges read the previous
//    row's outputs (prev_out) through nsrc, as a pair's B block reads A's;
//    K2 adds the next row's near grads to its cotangent sum in seg_merge,
//    and one more seg_merge (zero base, stored in T) sums the near edges'
//    value grads over nsrc into near_g_out. The same bytes as K1/K2 less
//    the near rows of the value gather: memory bound on paper.
// K2r (fused_row_backward with res=None, the in-kernel recompute): K1's
//    kernels recompute the residual streams into scratch from full-width
//    values, then K2's launches run on them (bitwise K2 fed by K1).
// K3 (pair forward) replaces dagnn_tpu/ops/pallas/pair_step.py
//    fused_pair_forward (_pair_fwd_kernel, _nf_rebuild_vals).
// K4 (pair backward) replaces pair_step.py fused_pair_backward
//    (_pair_bwd_kernel).
//
// Every launch covers a few direction blocks of Kn destination slots, named
// by a BLOCK TABLE passed by value (Tab). Per block: the weight direction,
// the node block (rows nb*Kn..), the edge range [eo, eo+ke), the first kv
// edges' values in `val` from row vo, the other (intra-pair) edges' values
// read from node block `src`'s outputs through nsrc (pad nsrc = Kn reads
// zero), and the transpose range [to, to+kt). A merged row (K1/K2) is the
// uniform table: block d is direction d, edges and values at d*Ke, no
// intra-pair edges. A pair (K3/K4) is [A0|A1|B0|B1] (A = row 2p, B = row
// 2p+1, digit = direction) with ragged widths, and the B blocks read their
// intra-pair values straight from the A blocks' output rows: no one-hot
// matrix, and the read is bitwise what a state-buffer gather gives.
//
// Each block runs every GRU layer: edge-type encoder, additive attention
// scores, a segment softmax over each destination's edges, the alpha-weighted
// value sum and a torch.nn.GRUCell update. The wrappers (ops/row_step.py,
// ops/pair_step.py) issue per layer and block group an attention launch and
// a GRU launch (K1, K3: groups [A0|A1] then [B0|B1], so B reads A's layer-l
// output), and for K2/K4 a transpose-grad merge, a state rebuild per
// layer, and per layer and group an elementwise GRU VJP, the two input-grad
// GEMMs in one launch, an attention VJP, a weight-grad GEMM and a
// bias/score weight reduction (13 launches a merged row). K4 runs group B first,
// then sums B's intra-pair value grads over nsrc into A's cotangent with the
// same merge kernel (a second index source), then runs group A.
//
// Translation from the TPU kernel: no one-hot matrices. A segment op is an
// indexed loop: one thread block per (block, destination slot) scans the
// block's edge list in order (warp ballots keep the order, so every sum runs
// in a fixed order) and owns that slot's softmax, aggregate and score
// gradients. The GRU products are shared-memory tiled GEMMs with float32
// accumulation and the gate math fused into their epilogue (in bf16 on the
// tensor cores, see below). Weight
// gradients are written per block tile or reduced over slots in a second
// pass: no atomics, so runs are deterministic. The two blocks of one launch
// that write weight grads must belong to different directions (checked).
//
// Rounding points of _layer_fwd / _layer_bwd are kept (each is an identity
// at float32): k cast to the compute type, q_score, the segment max and the
// denominator cast before use, val*alpha rounded before its f32 sum, z and
// n rounded before the combine (the backward rebuilds the output bitwise;
// the combine uses explicit _rn intrinsics so no FMA contraction changes
// it between the two kernels), an intra-pair value grad rounded to the
// compute type before its nsrc sum.
//
// What bounds it on an H100 (H 300, 2 layers, bf16). Merged row (Kn 256,
// Ke 512 per direction): K1 moves about 9 MB and does about 1.1 GFLOP, K2
// about 20 MB and 2.4 GFLOP. Pair at the flagship pair=2 batch (4 blocks of
// Kn 256, 2250 edges, 1734 gathered value rows, 1525 transpose edges): K3
// about 13 MB and 2.2 GFLOP, K4 about 26 MB and 4.8 GFLOP. All are memory
// bound on paper (a few us each); what bounds them is latency: each
// slot's chain of dependent loads in the segment ops (attn_fwd, seg_merge:
// see their notes) and the K loops of small GEMM tiles. The bf16 GEMMs,
// the forward's gru_fwd and the backward's gemm_nn, wgrad and rebuild, run
// on the tensor cores: mma.sync.m16n8k16 on 32 x 32 output tiles, operands
// kept bf16 in padded shared memory and read with ldmatrix, the next K
// stages streamed in with cp.async (below). The float32 route keeps the
// CUDA-core tiles: TF32 would break the float32 checks.
// On an H100 (chip_smoke.py, device time from a CUDA graph; PERF.md): K1
// 0.048 ms a merged row, K2 0.164, K3 0.102 a pair, K4 0.301. One merged
// row launch by launch (phases 3g, 3h), us: gru_fwd 15.0-15.2 (36.4-36.8
// TFLOP/s), attn_fwd 9.1-9.2, gemm_nn 12.3, wgrad 13.3-13.8, rebuild
// 6.7-6.9, attn_bwd 21.4-21.6; torch.matmul on the products of the four
// GEMMs 15.6, 14.4, 11.5 and 6.0 us. The
// tiles sit far from the tensor cores' rate: by the arithmetic, a gemm_nn
// launch's 320 tiles re-read about 37 MB of operands from L2 (32 x 900 and
// 900 x 32 bf16 each), and each K stage ends at a barrier; wgmma with TMA
// wants 16-byte-aligned rows (these are 600 and 1800 bytes), so padded
// scratch operands come first.

#include "common.cuh"

#include <type_traits>

#define MAXR 8
#define MAXB 4
#define TABW 9      // ints per block in the host table

// ------------------------------------------------------------ block table

struct Blk {
  int dir;   // weight direction
  int nb;    // node block: rows nb*Kn .. nb*Kn+Kn
  int eo;    // edge range [eo, eo+ke)
  int ke;
  int vo;    // values of edges e < kv: val rows vo+e
  int kv;
  int to;    // transpose (or merge-list) range [to, to+kt)
  int kt;
  int src;   // node block of the routed source (this call's outputs, K3/K4,
             // or prev_out, K7) that feeds edges e >= kv (-1: none)
};

struct Tab {
  Blk b[MAXB];
};

// Block i of a launch's table, selected with static indices only: indexing
// the by-value table with a run-time index makes the compiler copy it to
// local memory and starves the GEMM loops of registers.
__device__ __forceinline__ Blk pick(const Tab& tb, int i) {
  Blk b = tb.b[0];
#pragma unroll
  for (int j = 1; j < MAXB; ++j)
    if (i == j) b = tb.b[j];
  return b;
}

// GEMM_BLOCKS: the kernels that need no edge ranges (GRU forward and VJP,
// the GEMMs, the weight-grad reductions) take a launch's blocks as an
// affine map instead of a table: block z is direction z at node block
// nb0 + z. Every group a wrapper launches has that form ([d0|d1] of one
// row), and the kernels then index exactly as with uniform rows (a table
// lookup there cost the GEMM loops registers and 4-60% of their time on
// the H100). Its blocks are of different directions, so weight grads add
// per direction without atomics.

// where a block's edge values live
template <typename T>
struct Vals {
  const T* val;      // gathered rows: val[(vo + e) * ldv]
  int ldv;
  const int* nsrc;   // routed edges: source slot in node block src,
  const T* src;      // at src[(src * Kn + nsrc[eo + e]) * lds]
  int lds;
};

// ------------------------------------------------------------------ helpers

// a value row's element h; a null row (intra-pair pad) reads zero
template <typename T>
__device__ __forceinline__ float ldz(const T* row, int h) { return row ? ldf(row + h) : 0.f; }

template <typename T>
__device__ __forceinline__ const T* vrow(const Blk& b, int e, int Kn, const Vals<T>& vs) {
  if (e < b.kv) return vs.val + (size_t)(b.vo + e) * vs.ldv;
  const int s = vs.nsrc[b.eo + e];
  return (s >= 0 && s < Kn) ? vs.src + ((size_t)b.src * Kn + s) * vs.lds : nullptr;
}

__device__ __forceinline__ float sigm(float x) { return 1.f / (1.f + expf(-x)); }

// ((1 - z) * n + z * agg) * nmask, without FMA contraction
__device__ __forceinline__ float gru_combine(float zd, float nd, float ag, float nm) {
  return __fmul_rn(__fadd_rn(__fmul_rn(__fsub_rn(1.f, zd), nd), __fmul_rn(zd, ag)), nm);
}

__device__ __forceinline__ bool edge_valid(const int* edst, const float* emask, int e, int kn) {
  return emask[e] > 0.f && edst[e] >= 0 && edst[e] < kn;
}

#define BM 32
#define BN 32
#define BK 32
#define NT 256
static_assert(BM * BK % NT == 0 && BM == BK && BN == BK, "square tiles, whole per thread");

// ---------------------------------------------------- staged slot lists
// Helpers of the kernels that list one destination slot's entries (attn_fwd,
// seg_merge): the block's keys staged in shared memory in chunks, ballots
// from there, and V consecutive columns a lane.
#define SM_CHUNK 2048   // list entries staged in shared memory at a time
#define SM_U 4          // listed rows loaded together

// key[i] = idx[i] where mask[i] > 0, else -1, for i < ne (the whole block)
__device__ __forceinline__ void stage_keys(int* key, const int* ix, const float* mk, int ne) {
  int done = 0;
  if (((reinterpret_cast<uintptr_t>(ix) | reinterpret_cast<uintptr_t>(mk)) & 15) == 0) {
    done = ne & ~3;
    for (int i = threadIdx.x; i < (ne >> 2); i += blockDim.x) {
      const int4 a = reinterpret_cast<const int4*>(ix)[i];
      const float4 m = reinterpret_cast<const float4*>(mk)[i];
      reinterpret_cast<int4*>(key)[i] = make_int4(m.x > 0.f ? a.x : -1, m.y > 0.f ? a.y : -1,
                                                  m.z > 0.f ? a.z : -1, m.w > 0.f ? a.w : -1);
    }
  }
  for (int i = done + threadIdx.x; i < ne; i += blockDim.x) key[i] = mk[i] > 0.f ? ix[i] : -1;
}

// V consecutive elements as f32 (V = 8: one or two 16-byte loads; V = 4:
// one 8-byte bf16 or 16-byte f32 load)
template <int V>
__device__ __forceinline__ void ldv(const bf16* p, float* o) {
  if constexpr (V == 8 || V == 4) {
    uint32_t w[4];
    if constexpr (V == 8) {
      const uint4 q = *reinterpret_cast<const uint4*>(p);
      w[0] = q.x; w[1] = q.y; w[2] = q.z; w[3] = q.w;
    } else {
      const uint2 q = *reinterpret_cast<const uint2*>(p);
      w[0] = q.x; w[1] = q.y;
    }
#pragma unroll
    for (int i = 0; i < V / 2; ++i) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      o[2 * i] = f.x;
      o[2 * i + 1] = f.y;
    }
  } else {
    o[0] = ldf(p);
  }
}
template <int V>
__device__ __forceinline__ void ldv(const float* p, float* o) {
  if constexpr (V == 8 || V == 4) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
    if constexpr (V == 8) {
      const float4 b = reinterpret_cast<const float4*>(p)[1];
      o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
    }
  } else {
    o[0] = *p;
  }
}
template <int V>
__device__ __forceinline__ void stv(bf16* p, const float* v) {
  if constexpr (V == 8 || V == 4) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < V / 2; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    if constexpr (V == 8) *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
    else *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  } else {
    *p = cvt<bf16>(v[0]);
  }
}
template <int V>
__device__ __forceinline__ void stv(float* p, const float* v) {
  if constexpr (V == 8 || V == 4) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    if constexpr (V == 8) reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
    *p = v[0];
  }
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// ------------------------------------------------------- K1/K3: attention
// grid (Kn, nblk), block AF_THREADS. Scores, segment softmax and aggregate
// of one destination slot; writes alpha32 (optional) and agg. Dynamic
// shared memory: kemax value-row pointers, edge ids and scores (a slot may
// own every edge of its block), and the direction's key-score weights in
// f32 (wk, be, we: H (R + 2) values, staged once a block).
//
// Design. A call moves about 1.25 MB at the flagship merged row (0.37 us at
// 3.35 TB/s); what bounds it is each slot's chain of dependent latencies,
// so no step of the chain scans device memory: as in seg_merge, the block
// stages its keys (edst where emask is set, else -1) in shared memory,
// 16-byte loads where aligned, and warp 0 ballots the slot's edges out of
// shared memory into an ascending list; the q score's loads and the
// direction's key-score weights (staged in f32) are in flight meanwhile.
// A warp an edge computes its key score (V value columns a lane); warp 0
// runs the max and the exps across its lanes and the denominator in
// ascending edge order by shuffles; then every thread owns V columns of
// the aggregate and loads SM_U listed value rows at once before adding
// them in list order. Every per-slot f32 sum runs in ascending edge order
// (bit repeatable); the key scores sum a row's columns in another order at
// V = 4 than at V = 1.
#define AF_THREADS 128
#define AF_U 4          // loads in flight a thread while staging

// dst[(i % R) * H + i / R] = src[i] in f32 for i < n (R = 1: a copy; else
// the transpose of a [H, R] matrix), AF_U loads in flight a thread (one
// loop over all the staged weights, ten loads a thread, was slower on the
// H100).
template <typename T>
__device__ __forceinline__ void stage_f32(float* dst, const T* src, int n, int R, int H) {
  for (int i0 = threadIdx.x; i0 < n; i0 += AF_U * AF_THREADS) {
    float x[AF_U];
#pragma unroll
    for (int u = 0; u < AF_U; ++u) {
      const int i = i0 + u * AF_THREADS;
      x[u] = i < n ? ldf(src + i) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < AF_U; ++u) {
      const int i = i0 + u * AF_THREADS;
      if (i < n) dst[(i % R) * H + i / R] = x[u];
    }
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(AF_THREADS) attn_fwd_kernel(
    Tab tb, int Kn, int H, int Dq, int R, const T* q, int ldq, Vals<T> vs, const T* ea,
    const int* edst_all, const float* emask_all, const T* wq_all, const T* wk_all,
    const T* b_all, const T* we_all, const T* be_all, float* a32, int lda32, T* agg,
    int ldagg, int kemax) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(16) int key[SM_CHUNK];
  __shared__ int s_cnt;
  __shared__ float s_red[AF_THREADS / 32];
  const Blk b = pick(tb, blockIdx.y);
  const T** vp = reinterpret_cast<const T**>(smem);
  int* lst = reinterpret_cast<int*>(vp + kemax);
  float* sc = reinterpret_cast<float*>(lst + kemax);
  float* swk = sc + kemax;                  // wk [H], be [H], we^T [R, H] in f32
  float* sbe = swk + H;
  float* swe = sbe + H;
  const int n = blockIdx.x, d = b.dir;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int NW = AF_THREADS / 32;
  const int* edst = edst_all + b.eo;
  const float* emask = emask_all + b.eo;
  const T* wq = wq_all + (size_t)d * Dq;
  const T* wk = wk_all + (size_t)d * H;
  const T* we = we_all ? we_all + (size_t)d * H * R : nullptr;
  const T* be = be_all ? be_all + (size_t)d * H : nullptr;
  const float bias = ldf(b_all + d);
  const size_t row = (size_t)b.nb * Kn + n;

  // alpha32 of invalid edges is 0: edge e is the block of slot e mod Kn's
  if (a32)
    for (int e = n + tid * Kn; e < b.ke; e += AF_THREADS * Kn)
      if (!edge_valid(edst, emask, e, Kn)) a32[(size_t)(b.eo + e) * lda32] = 0.f;
  // the q score's partial (k ascending a thread), then the weights
  float p = 0.f;
  for (int k0 = tid; k0 < Dq; k0 += AF_U * AF_THREADS) {
    float x[AF_U], y[AF_U];
#pragma unroll
    for (int u = 0; u < AF_U; ++u) {
      const int k = k0 + u * AF_THREADS;
      x[u] = k < Dq ? ldf(q + row * ldq + k) : 0.f;
      y[u] = k < Dq ? ldf(wq + k) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < AF_U; ++u)
      if (k0 + u * AF_THREADS < Dq) p += x[u] * y[u];
  }
  stage_f32(swk, wk, H, 1, H);
  if (ea) {
    stage_f32(sbe, be, H, 1, H);
    stage_f32(swe, we, H * R, R, H);
  }
  p = warp_sum(p);
  if (lane == 0) s_red[warp] = p;
  int m = 0;                                // the slot's edges listed (warp 0)
  for (int e0 = 0; e0 < b.ke; e0 += SM_CHUNK) {
    const int ne = min(SM_CHUNK, b.ke - e0);
    __syncthreads();                        // warp 0 is done with the last chunk
    stage_keys(key, edst + e0, emask + e0, ne);
    __syncthreads();
    if (warp == 0)
      for (int base = 0; base < ne; base += 32) {
        const int e = base + lane;
        const bool hit = e < ne && key[e] == n;
        const unsigned bal = __ballot_sync(0xffffffffu, hit);
        if (hit) lst[m + __popc(bal & ((1u << lane) - 1u))] = e0 + e;
        m += __popc(bal);
      }
  }
  if (tid == 0) s_cnt = m;
  __syncthreads();
  m = s_cnt;
  for (int j = warp; j < m; j += NW) {      // key scores, a warp an edge
    const int e = lst[j];
    const size_t er = (size_t)b.eo + e;
    const T* v = vrow<T>(b, e, Kn, vs);
    if (lane == 0) vp[j] = v;
    float eav[MAXR];
#pragma unroll
    for (int r = 0; r < MAXR; ++r) eav[r] = ea && r < R ? ldf(ea + er * R + r) : 0.f;
    float s = 0.f;
    for (int c = lane * V; c < H; c += 32 * V) {
      float x[V], wk4[V], be4[V], we4[MAXR][V];
      if (v) {
        ldv<V>(v + c, x);
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) x[i] = 0.f;
      }
      ldv<V>(swk + c, wk4);                 // V consecutive floats: no bank conflicts
      if (ea) {
        ldv<V>(sbe + c, be4);
#pragma unroll
        for (int r = 0; r < MAXR; ++r)
          if (r < R) ldv<V>(swe + r * H + c, we4[r]);
      }
#pragma unroll
      for (int i = 0; i < V; ++i) {
        float kk = x[i];
        if (ea) {
          float enc = 0.f;
#pragma unroll
          for (int r = 0; r < MAXR; ++r)
            if (r < R) enc += eav[r] * we4[r][i];
          kk = rnd<T>((kk + enc) + be4[i]);
        }
        s += kk * wk4[i];
      }
    }
    s = warp_sum(s);
    if (lane == 0) sc[j] = s + bias;
  }
  __syncthreads();
  if (warp == 0) {                          // the slot's softmax
    float qs = 0.f;
    for (int w = 0; w < NW; ++w) qs += s_red[w];
    qs = rnd<T>(qs);
    float mx = -FLT_MAX;
    for (int j = lane; j < m; j += 32) {
      sc[j] = qs + sc[j];
      mx = fmaxf(mx, sc[j]);
    }
    mx = warp_max(mx);
    if (mx <= -FLT_MAX) mx = 0.f;
    const float smd = rnd<T>(mx);
    float den = 0.f;
    for (int base = 0; base < m; base += 32) {
      const int j = base + lane;
      float ex = 0.f;
      if (j < m) {
        ex = expf(sc[j] - smd);
        sc[j] = ex;
      }
      const float rx = rnd<T>(ex);
      const int c = min(32, m - base);
      for (int u = 0; u < c; ++u) den += __shfl_sync(0xffffffffu, rx, u);   // in edge order
    }
    const float dd = rnd<T>(den) + 1e-16f;
    for (int j = lane; j < m; j += 32) {
      const float al = sc[j] / dd;
      if (a32) a32[(size_t)(b.eo + lst[j]) * lda32] = al;
      sc[j] = rnd<T>(al);
    }
  }
  __syncthreads();
  for (int col = tid * V; col < H; col += AF_THREADS * V) {   // the aggregate
    float acc[V];
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = 0.f;
    for (int j = 0; j < m; j += SM_U) {
      float x[SM_U][V];
#pragma unroll
      for (int u = 0; u < SM_U; ++u) {
        const T* v = j + u < m ? vp[j + u] : nullptr;
        if (v) {
          ldv<V>(v + col, x[u]);
        } else {
#pragma unroll
          for (int i = 0; i < V; ++i) x[u][i] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < SM_U; ++u)
        if (j + u < m) {
          const float al = sc[j + u];
#pragma unroll
          for (int i = 0; i < V; ++i) acc[i] += rnd<T>(x[u][i] * al);
        }
    }
    stv<V>(agg + row * ldagg + col, acc);
  }
}

// Shared-memory tile loader: s[r][c] = A[(r0 + r) * lda + c0 + c], zero
// outside the [R, C] matrix. Each thread stages its BM*BK/NT elements in
// registers before storing any: left to itself the compiler may pair each
// global load with its store and pay the load latency once per element
// (seen on the H100: 60% slower GEMMs).
template <typename T>
__device__ __forceinline__ void load_tile(float (*s)[BK + 1], const T* A, size_t lda,
                                          int R, int C, int r0, int c0) {
  constexpr int PER = BM * BK / NT;
  float v[PER];
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int i = threadIdx.x + u * NT, r = r0 + i / BK, c = c0 + i % BK;
    v[u] = (r < R && c < C) ? ldf(A + (size_t)r * lda + c) : 0.f;
  }
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int i = threadIdx.x + u * NT;
    s[i / BK][i % BK] = v[u];
  }
}

// ------------------------------------ bf16 GEMM tiles on the tensor cores
// K2/K4's GEMMs in bf16 (gemm_nn, wgrad, rebuild; K1/K3's gru_fwd runs
// the same pieces in its own K loop, tc_gru): a block of TC_THREADS =
// 4 warps owns a TT x TT output tile (small, so a one-direction launch of
// [256, 300] outputs still has 80 blocks), each warp a 16 x 16 quarter, two
// mma.sync.m16n8k16 (bf16 in, f32 accumulate) per 16-deep step. Operand
// tiles stay bf16 in shared memory, rows padded by 8 elements (80 or 144
// bytes: the 8 rows an ldmatrix reads fall on distinct banks), read with
// ldmatrix (.trans where the operand is stored k-major: the [K, N] weight,
// wgrad's transposed A and its [m, k] X). K advances TK a stage (TK / 16
// mma steps between barriers); the next stages stream in with cp.async
// into a TSTAGES ring while the current one multiplies. Operand
// rows are 600 or 1800 bytes at the flagship width: 8-byte aligned, not
// 16, so the copies are 8 bytes (4 elements, zero-filled past the edge);
// a launch whose leading dimensions or pointers are not 8-byte aligned
// (odd widths) stages through registers instead (ASYNC false).
#define TT 32           // output tile TT x TT
#define TSTAGES 3
#define TC_THREADS 128
// K depth of a stage. 64 halves gemm_nn's barriers over its K = 3H; wgrad
// (K = Kn) and rebuild (K = H) keep 32, since at 64 a block's ring takes
// 30 KB of shared memory and wgrad's 1,160 blocks no longer fit one wave.
#define TK_NN 64
#define TK_WG 32
#define TK_RB 32
static_assert(TT == BM && TT == BN, "the bf16 and f32 routes share the grids");

// a TSTAGES ring of both operands' stages, TK deep; either way round an
// operand's stage takes at most (TT + 8) * TK elements
template <int TK>
struct TcSmem {
  bf16 a[TSTAGES][(TT + 8) * TK];
  bf16 b[TSTAGES][(TT + 8) * TK];
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void ldsm4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}
__device__ __forceinline__ void ldsm4t(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}
__device__ __forceinline__ void mma16816(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// s[r * (COLS + 8) + c] = G[(r0 + r) * ld + c0 + c] for a ROWS x COLS
// stage, zero outside the [R, C] matrix; 4-element chunks, by the
// TC_THREADS threads tid of one warp group
template <bool ASYNC, int ROWS, int COLS>
__device__ __forceinline__ void tc_load(bf16* s, const bf16* G, size_t ld, int R, int C, int r0,
                                        int c0, int tid) {
  constexpr int LDS = COLS + 8, CPR = COLS / 4, PER = ROWS * CPR / TC_THREADS;
  static_assert(ROWS * CPR % TC_THREADS == 0, "whole chunks a thread");
  if constexpr (ASYNC) {
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int i = tid + u * TC_THREADS, r = i / CPR, c = (i % CPR) * 4;
      const int gr = r0 + r, gc = c0 + c;
      const int nv = (gr < R && gc < C) ? min(4, C - gc) : 0;
      cp_async8(s + r * LDS + c, nv ? G + (size_t)gr * ld + gc : G, 2 * nv);
    }
  } else {
    bf16 v[PER][4];
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int i = tid + u * TC_THREADS, gr = r0 + i / CPR, gc = c0 + (i % CPR) * 4;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[u][e] = (gr < R && gc + e < C) ? G[(size_t)gr * ld + gc + e] : __float2bfloat16_rn(0.f);
    }
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int i = tid + u * TC_THREADS;
#pragma unroll
      for (int e = 0; e < 4; ++e) s[(i / CPR) * LDS + (i % CPR) * 4 + e] = v[u][e];
    }
  }
}

// acc[nb][i] = sum_k A(m, k) B(k, n) over the block's tile at (m0, n0):
// A(m, k) at A[m * lda + k], or A[k * lda + m] with A_KM; B(k, n) at
// B[n * ldb + k], or B[k * ldb + n] with B_KN. A stage holds an operand as
// stored: [TT][TK] rows of k, or [TK][TT] rows of m (n), each row padded by
// 8 elements. Element i of n8 block nb is row m0 + tc_row(i, t), column
// n0 + tc_col(nb, i, t) of thread t.
template <int TK, bool A_KM, bool B_KN, bool ASYNC>
__device__ __forceinline__ void tc_gemm(TcSmem<TK>& sm, const bf16* A, size_t lda, const bf16* B,
                                        size_t ldb, int M, int N, int K, int m0, int n0,
                                        float acc[2][4]) {
  constexpr int LK = TK + 8, LT = TT + 8;   // row strides of the two layouts
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = (warp & 1) * 16, wn = (warp >> 1) * 16;
#pragma unroll
  for (int nb = 0; nb < 2; ++nb)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nb][i] = 0.f;
  const int nk = (K + TK - 1) / TK;
  auto load = [&](int st, int k0) {
    const int t = threadIdx.x;
    if constexpr (A_KM) tc_load<ASYNC, TK, TT>(sm.a[st], A, lda, K, M, k0, m0, t);
    else tc_load<ASYNC, TT, TK>(sm.a[st], A, lda, M, K, m0, k0, t);
    if constexpr (B_KN) tc_load<ASYNC, TK, TT>(sm.b[st], B, ldb, K, N, k0, n0, t);
    else tc_load<ASYNC, TT, TK>(sm.b[st], B, ldb, N, K, n0, k0, t);
  };
#pragma unroll
  for (int st = 0; st < TSTAGES - 1; ++st) {
    if (st < nk) load(st, st * TK);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<TSTAGES - 2>();           // stage kt has landed (this thread's part)
    __syncthreads();                        // everyone's part; stage kt-1 is free
    const int pf = kt + TSTAGES - 1;
    if (pf < nk) load(pf % TSTAGES, pf * TK);
    cp_async_commit();
    const bf16* sa = sm.a[kt % TSTAGES];
    const bf16* sb = sm.b[kt % TSTAGES];
#pragma unroll
    for (int kk = 0; kk < TK; kk += 16) {
      uint32_t a[4], b[4];
      if constexpr (A_KM)
        ldsm4t(a, sa + (kk + (lane & 7) + (lane >> 4) * 8) * LT + wm + ((lane >> 3) & 1) * 8);
      else
        ldsm4(a, sa + (wm + (lane & 7) + ((lane >> 3) & 1) * 8) * LK + kk + (lane >> 4) * 8);
      if constexpr (B_KN)
        ldsm4t(b, sb + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * LT + wn + (lane >> 4) * 8);
      else
        ldsm4(b, sb + (wn + (lane & 7) + (lane >> 4) * 8) * LK + kk + ((lane >> 3) & 1) * 8);
      mma16816(acc[0], a, b[0], b[1]);
      mma16816(acc[1], a, b[2], b[3]);
    }
  }
  cp_async_wait<0>();
}

// of thread t of a TC_THREADS warp group
__device__ __forceinline__ int tc_row(int i, int t) {
  return ((t >> 5) & 1) * 16 + ((t & 31) >> 2) + 8 * (i >> 1);
}
__device__ __forceinline__ int tc_col(int nb, int i, int t) {
  return (t >> 6) * 16 + 8 * nb + 2 * (t & 3) + (i & 1);
}

// ------------------------------------------------------------- K1/K3: GRU
// grid (ceil(H/32), ceil(Kn/32), nblk). out = GRU(cur, agg), r/z/n
// residuals optional. Block z: direction z, node block nb0 + z (see
// GEMM_BLOCKS). A tile's four products, r: cur w_ih_r + agg w_hh_r, z: the
// same with the z rows, i_n: cur w_ih_n, h_n: agg w_hh_n, all with f32
// sums; the gate math in the epilogue, per output element.
//
// bf16: two warp groups of TC_THREADS split K: group 0 sums cur's
// products (cur w_ih^T, K = Din), group 1 agg's (agg w_hh^T, K = H), each
// over its own GRU_STAGES ring of TK_GRU-deep stages: one A tile and the r,
// z and n rows of its weight, read as stored ([3H, K], rows of k), TT x
// TK_GRU each, one A fragment feeding the three weights' mma.sync. So a
// tile runs twice the warps over half the chain of stages. Each stage's
// products go into fresh accumulators that are then added to the f32
// sums: mma.sync's accumulate truncates, and a chain of them through one
// register drifted far enough from round-to-nearest to flip z's and n's
// bf16 roundings often (the step checks saw it); stage sums rounded to
// nearest keep the plain version's accuracy. The two groups then trade
// partial sums through shared memory (r = cur's + agg's, one f32 add) and
// each writes half the tile. The rings, GRU_STAGES deep, take 80 KB of
// dynamic shared memory (on the H100 4 stages ran a little faster than 3,
// with the same bits; TK_GRU 64 at 120 KB was slower).
// float32: the CUDA-core tile (NT threads; thread (ty, tx): hidden unit
// h0+tx, rows m0+ty+8i), exact f32 products.
#define TK_GRU 32
#define GRU_STAGES 4
#define GRU_THREADS (2 * TC_THREADS)

struct GruStage {
  bf16 a[TT * (TK_GRU + 8)];
  bf16 w[3][TT * (TK_GRU + 8)];
};

// one warp group's sums over K: acc[g][nb][i], g 0 r, 1 z, 2 the n gate's
// (i_n from cur, h_n from agg); element (nb, i) at row m0 + tc_row(i, t),
// unit h0 + tc_col(nb, i, t). Every thread of the block runs nk_all stages
// (the longer group's count) so that both groups meet the same barriers.
template <bool ASYNC>
__device__ __forceinline__ void tc_gru(GruStage* ring, const bf16* A, size_t lda, const bf16* W,
                                       int M, int H, int K, int nk_all, int m0, int h0,
                                       float acc[3][2][4]) {
  constexpr int TK = TK_GRU, LK = TK + 8;
  const int t = threadIdx.x % TC_THREADS, lane = t & 31, warp = t >> 5;
  const int wm = (warp & 1) * 16, wn = (warp >> 1) * 16;
#pragma unroll
  for (int g = 0; g < 3; ++g)
#pragma unroll
    for (int nb = 0; nb < 2; ++nb)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[g][nb][i] = 0.f;
  const int nk = (K + TK - 1) / TK;
  auto load = [&](int st, int s) {
    const int k0 = s * TK;
    tc_load<ASYNC, TT, TK>(ring[st].a, A, lda, M, K, m0, k0, t);
#pragma unroll
    for (int g = 0; g < 3; ++g)
      tc_load<ASYNC, TT, TK>(ring[st].w[g], W + (size_t)g * H * K, K, H, K, h0, k0, t);
  };
#pragma unroll
  for (int st = 0; st < GRU_STAGES - 1; ++st) {
    if (st < nk) load(st, st);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk_all; ++kt) {
    cp_async_wait<GRU_STAGES - 2>();
    __syncthreads();
    const int pf = kt + GRU_STAGES - 1;
    if (pf < nk) load(pf % GRU_STAGES, pf);
    cp_async_commit();
    if (kt >= nk) continue;
    const GruStage& sg = ring[kt % GRU_STAGES];
    float part[3][2][4];
#pragma unroll
    for (int g = 0; g < 3; ++g)
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
#pragma unroll
        for (int i = 0; i < 4; ++i) part[g][nb][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < TK; kk += 16) {
      uint32_t a[4];
      ldsm4(a, sg.a + (wm + (lane & 7) + ((lane >> 3) & 1) * 8) * LK + kk + (lane >> 4) * 8);
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        uint32_t b[4];
        ldsm4(b, sg.w[g] + (wn + (lane & 7) + (lane >> 4) * 8) * LK + kk + ((lane >> 3) & 1) * 8);
        mma16816(part[g][0], a, b[0], b[1]);
        mma16816(part[g][1], a, b[2], b[3]);
      }
    }
#pragma unroll
    for (int g = 0; g < 3; ++g)
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[g][nb][i] += part[g][nb][i];
  }
  cp_async_wait<0>();
}

// one output element: the gates from the four sums, z and n rounded before
// the combine (K2's rebuild recombines the stored z and n bit for bit)
template <typename T>
__device__ __forceinline__ void gru_out(int d, int Kn, int H, int m, int h, size_t r0, float sr,
                                        float sz, float si, float sh, const T* brz_all,
                                        const T* bin_all, const T* bhn_all, const T* agg,
                                        int ldg, const float* nmask, T* out, int ldo, T* rr,
                                        T* zz, T* nn, int ldres) {
  if (m >= Kn || h >= H) return;
  const size_t row = r0 + m;
  const float r = sigm(sr + ldf(brz_all + (size_t)d * 2 * H + h));
  const float z = sigm(sz + ldf(brz_all + (size_t)d * 2 * H + H + h));
  const float hn = sh + ldf(bhn_all + (size_t)d * H + h);
  const float n = tanhf((si + ldf(bin_all + (size_t)d * H + h)) + r * hn);
  const float zd = rnd<T>(z), nd = rnd<T>(n);
  const float ag = ldf(agg + row * ldg + h);
  out[row * ldo + h] = cvt<T>(gru_combine(zd, nd, ag, nmask[row]));
  if (rr) {
    rr[row * ldres + h] = cvt<T>(r);
    zz[row * ldres + h] = cvt<T>(z);
    nn[row * ldres + h] = cvt<T>(n);
  }
}

template <typename T, bool ASYNC>
__global__ void __launch_bounds__(NT) gru_fwd_kernel(
    int nb0, int Kn, int H, int Din, const T* cur, int ldc, const T* agg, int ldg,
    const T* wih_all, const T* whh_all, const T* brz_all, const T* bin_all,
    const T* bhn_all, const float* nmask, T* out, int ldo, T* rr, T* zz, T* nn,
    int ldres) {
  const int d = blockIdx.z, h0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const size_t r0 = (size_t)(nb0 + d) * Kn;
  const T* wih = wih_all + (size_t)d * 3 * H * Din;
  const T* whh = whh_all + (size_t)d * 3 * H * H;
  const T* curd = cur + r0 * ldc;
  const T* aggd = agg + r0 * ldg;
  if constexpr (std::is_same<T, bf16>::value) {
    extern __shared__ __align__(16) unsigned char gsm[];
    const int grp = threadIdx.x / TC_THREADS, t = threadIdx.x % TC_THREADS, o = 1 - grp;
    const int nx = (Din + TK_GRU - 1) / TK_GRU, nh = (H + TK_GRU - 1) / TK_GRU;
    float acc[3][2][4];
    tc_gru<ASYNC>(reinterpret_cast<GruStage*>(gsm) + grp * GRU_STAGES, grp ? aggd : curd,
                  grp ? ldg : ldc, grp ? whh : wih, Kn, H, grp ? H : Din, max(nx, nh), m0, h0,
                  acc);
    // group g writes n8 block g of every warp's tile and sends block o (the
    // selects keep the register arrays statically indexed)
    float* xch = reinterpret_cast<float*>(gsm);   // [group][gate][i][t]
    __syncthreads();                              // both rings are drained
#pragma unroll
    for (int g = 0; g < 3; ++g)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        xch[((grp * 3 + g) * 4 + i) * TC_THREADS + t] = grp ? acc[g][0][i] : acc[g][1][i];
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float y[3], k[3];
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        y[g] = xch[((o * 3 + g) * 4 + i) * TC_THREADS + t];
        k[g] = grp ? acc[g][1][i] : acc[g][0][i];
      }
      gru_out<T>(d, Kn, H, m0 + tc_row(i, t), h0 + tc_col(grp, i, t), r0, k[0] + y[0],
                 k[1] + y[1], grp ? y[2] : k[2], grp ? k[2] : y[2], brz_all, bin_all, bhn_all,
                 agg, ldg, nmask, out, ldo, rr, zz, nn, ldres);
    }
  } else {
    __shared__ float sA[BM][BK + 1];
    __shared__ float sW[3][BN][BK + 1];
    const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int g = 0; g < 4; ++g) acc[i][g] = 0.f;

    for (int phase = 0; phase < 2; ++phase) {
      const T* A = phase ? aggd : curd;
      const size_t lda = phase ? ldg : ldc;
      const T* W = phase ? whh : wih;
      const int K = phase ? H : Din;
      const int g2 = phase ? 3 : 2;  // n-gate accumulator: i_n or h_n
      for (int k0 = 0; k0 < K; k0 += BK) {
        load_tile<T>(sA, A, lda, Kn, K, m0, k0);
        for (int g = 0; g < 3; ++g) load_tile<T>(sW[g], W + (size_t)g * H * K, K, H, K, h0, k0);
        __syncthreads();
#pragma unroll 8
        for (int kk = 0; kk < BK; ++kk) {
          const float w0 = sW[0][tx][kk], w1 = sW[1][tx][kk], w2 = sW[2][tx][kk];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float av = sA[ty + 8 * i][kk];
            acc[i][0] += av * w0;
            acc[i][1] += av * w1;
            acc[i][g2] += av * w2;
          }
        }
        __syncthreads();
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      gru_out<T>(d, Kn, H, m0 + ty + 8 * i, h0 + tx, r0, acc[i][0], acc[i][1], acc[i][2],
                 acc[i][3], brz_all, bin_all, bhn_all, agg, ldg, nmask, out, ldo, rr, zz, nn,
                 ldres);
  }
}

// ------------------------------------------------ K2/K4/K5/K7: seg merge
// base + (the sum of src rows over the list entries [to, to+kt) whose idx
// is slot n (mask set), plus gadd's row if given), in f32. The list's src
// rows start at row `to`, or with src_at_vo at row `vo` (K7's near-grad
// merge, whose grads and indices lie at different offsets). base is g
// (K2/K4's transpose-grad merge, K7's adding the next row's near grads as
// gadd, and K5: src tg, idx tdst), gtot itself with g null (K4's
// intra-pair merge: src the B blocks' intra-pair value grads, idx nsrc,
// list = B_d's intra-pair range, node block A_d), or 0 with both null
// (K7's near-grad merge: src the near edges' value grads, idx nsrc). The
// sum goes to the f32 gtot, or with gout set (K5, K7) to gout rounded to T.
//
// Design. A call moves little (K5 at Kn 256, Kt 512, L*H 600 in bf16:
// 1.23 MB, 0.37 us at 3.35 TB/s); what bounds it is each slot's chain of
// dependent latencies. The first version took a block per slot whose warp
// 0 alone ballot-scanned the whole list from device memory (16 dependent
// rounds at Kt 512) before any row moved: 9.8 us against 5.8 us for
// index_add_ on the H100 (PERF.md). Here grid (Kn, nblk): one slot a block, SM_WPS
// warps, each a share of its columns: the block stages its list's
// keys (idx where mask is set, else -1) in shared memory once, 16-byte
// loads where aligned, in chunks of SM_CHUNK entries; each warp ballots its
// slot's entries out of shared memory into a short list (ascending: __popc
// of the ballot below its lane), then loads SM_U listed src rows at once
// before adding them in order, so the scan never waits on a load and the
// rows' latencies overlap; V columns a lane at a time (V = 8: 16-byte bf16
// loads, when L*H and every pointer allow it). The base and gadd rows are
// loaded before the scan. The f32 order is the first version's (entries
// ascending, then gadd, then the base), and so are the outputs, bit for
// bit. One slot a block, with 4 warps sharing its columns: the more warps
// share a slot's chain of loads, the shorter each warp's part of it.
#define SM_WPS 4        // warps a slot (and a block); they split its columns
#define SM_LCAP 64      // a warp's list; added up when the next ballot could overflow it

template <typename T, int V>
__global__ void __launch_bounds__(SM_WPS * 32) seg_merge_kernel(
    Tab tb, int Kn, int LH, int src_at_vo, const T* g, const T* src, const int* idx,
    const float* mask, const T* gadd, float* gtot, T* gout) {
  __shared__ __align__(16) int key[SM_CHUNK];
  __shared__ int lists[SM_WPS][SM_LCAP];
  const Blk b = pick(tb, blockIdx.y);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int* lst = lists[warp];
  // The slot is blockIdx.x, written as block + warp / SM_WPS (0 here) and
  // guarded by n < Kn (always true): in this form nvcc compiles the 16-byte
  // merge to 92 registers a thread (80 with n = blockIdx.x alone), and the
  // H100 runs it faster, with the same bits (PERF.md).
  const int n = blockIdx.x + warp / SM_WPS, part = warp % SM_WPS;
  const bool live = n < Kn;
  const size_t row = (size_t)b.nb * Kn + n;
  const size_t so = src_at_vo ? b.vo : b.to;
  const int nch = (b.kt + SM_CHUNK - 1) / SM_CHUNK;
  constexpr int CW = 32 * V * SM_WPS;       // columns a pass
  for (int c0 = 0; c0 < LH; c0 += CW) {
    const int col = c0 + (part * 32 + lane) * V;
    float acc[V], ad[V], bs[V];
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = ad[i] = bs[i] = 0.f;
    if (live && col < LH) {
      if (gadd) ldv<V>(gadd + row * LH + col, ad);
      if (g) ldv<V>(g + row * LH + col, bs);
      else if (gtot) ldv<V>(gtot + row * LH + col, bs);
    }
    for (int ch = 0; ch < nch; ++ch) {
      const int e0 = ch * SM_CHUNK, ne = min(SM_CHUNK, b.kt - e0);
      if (nch > 1 || c0 == 0) {
        __syncthreads();                    // every warp is done with the last chunk
        stage_keys(key, idx + b.to + e0, mask + b.to + e0, ne);
        __syncthreads();
      }
      if (!live) continue;
      int cnt = 0;                          // entries listed, not yet added
      for (int base = 0; base < ne; base += 32) {
        const int e = base + lane;
        const bool hit = e < ne && key[e] == n;
        const unsigned m = __ballot_sync(0xffffffffu, hit);
        if (hit) lst[cnt + __popc(m & ((1u << lane) - 1u))] = e0 + e;
        cnt += __popc(m);
        if (cnt <= SM_LCAP - 32 && base + 32 < ne) continue;
        __syncwarp();
        for (int j = 0; j < cnt; j += SM_U) {   // the listed rows, SM_U in flight
          int js[SM_U];
#pragma unroll
          for (int u = 0; u < SM_U; ++u) js[u] = j + u < cnt ? lst[j + u] : -1;
          float x[SM_U][V];
#pragma unroll
          for (int u = 0; u < SM_U; ++u)
            if (js[u] >= 0 && col < LH) ldv<V>(src + (so + js[u]) * LH + col, x[u]);
#pragma unroll
          for (int u = 0; u < SM_U; ++u)
            if (js[u] >= 0 && col < LH)
#pragma unroll
              for (int i = 0; i < V; ++i) acc[i] += x[u][i];
        }
        __syncwarp();
        cnt = 0;
      }
    }
    if (!live || col >= LH) continue;
    float o[V];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      float s = acc[i];
      if (gadd) s += ad[i];
      o[i] = bs[i] + s;
    }
    if (gout) stv<V>(gout + row * LH + col, o);
    else stv<V>(gtot + row * LH + col, o);
  }
}

// --------------------------------------------------------- K2/K4: rebuild
// grid (ceil(H/32), ceil(Kn/32), nblk): h_n = agg w_hn^T + b_hn (rounded),
// and the layer output rebuilt from the residuals (optional). bf16: the
// tensor-core tile (TC_THREADS; agg [m, k], w_hn [h, k]); float32: the
// CUDA-core tile (NT threads, 4 rows a thread), exact f32 products.
template <typename T>
__device__ __forceinline__ void rebuild_out(int Kn, int H, int m, int h, size_t r0, float acc,
                                            float bb, const T* agg, const T* z, const T* nres_n,
                                            int ldres, const float* nmask, T* hn, T* cur_out,
                                            int ldo) {
  if (m >= Kn || h >= H) return;
  const size_t row = r0 + m;
  hn[row * H + h] = cvt<T>(acc + bb);
  if (cur_out) {
    const float zd = ldf(z + row * ldres + h), nd = ldf(nres_n + row * ldres + h);
    const float ag = ldf(agg + row * ldres + h);
    cur_out[row * ldo + h] = cvt<T>(gru_combine(zd, nd, ag, nmask[row]));
  }
}

template <typename T, bool ASYNC>
__global__ void __launch_bounds__(NT) rebuild_kernel(
    Tab tb, int Kn, int H, const T* agg, const T* z, const T* nres_n, int ldres,
    const T* whh_all, const T* bhh_all, const float* nmask, T* hn, T* cur_out, int ldo) {
  const Blk b = pick(tb, blockIdx.z);
  const int d = b.dir, h0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const size_t r0 = (size_t)b.nb * Kn;
  const T* whn = whh_all + (size_t)d * 3 * H * H + (size_t)2 * H * H;
  const T* aggd = agg + r0 * ldres;
  const T* bhn = bhh_all + (size_t)d * 3 * H + 2 * H;
  if constexpr (std::is_same<T, bf16>::value) {
    __shared__ __align__(16) TcSmem<TK_RB> sm;
    float acc[2][4];
    tc_gemm<TK_RB, false, false, ASYNC>(sm, aggd, ldres, whn, H, Kn, H, H, m0, h0, acc);
#pragma unroll
    for (int nb = 0; nb < 2; ++nb)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int h = h0 + tc_col(nb, i, threadIdx.x);
        rebuild_out<T>(Kn, H, m0 + tc_row(i, threadIdx.x), h, r0, acc[nb][i],
                       h < H ? ldf(bhn + h) : 0.f,
                       agg, z, nres_n, ldres, nmask, hn, cur_out, ldo);
      }
  } else {
    __shared__ float sA[BM][BK + 1];
    __shared__ float sW[BN][BK + 1];
    const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k0 = 0; k0 < H; k0 += BK) {
      load_tile<T>(sA, aggd, ldres, Kn, H, m0, k0);
      load_tile<T>(sW, whn, H, H, H, h0, k0);
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < BK; ++kk) {
        const float w = sW[tx][kk];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i] += sA[ty + 8 * i][kk] * w;
      }
      __syncthreads();
    }
    const int h = h0 + tx;
    const float bb = h < H ? ldf(bhn + h) : 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      rebuild_out<T>(Kn, H, m0 + ty + 8 * i, h, r0, acc[i], bb, agg, z, nres_n, ldres, nmask,
                     hn, cur_out, ldo);
  }
}

// ------------------------------------------- K2/K4: GRU VJP, elementwise
// 1-D grid over nblk*Kn*H; block z of GEMM_BLOCKS.
template <typename T>
__global__ void gru_bwd_elem_kernel(int nb0, int total, int Kn, int H, const float* gtot,
                                    int ldgt, const float* gnext, const float* nmask,
                                    const T* agg, const T* r_, const T* z_, const T* n_,
                                    int ldres, const T* hn, T* dgi, T* dgh, float* gz) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int per = Kn * H;
  const int bi = idx / per, rem = idx % per;
  const size_t row = (size_t)(nb0 + bi) * Kn + rem / H;
  const int h = rem % H;
  float g = gtot[row * ldgt + h];
  if (gnext) g = g + gnext[row * H + h];
  g = g * nmask[row];
  const float r = ldf(r_ + row * ldres + h), z = ldf(z_ + row * ldres + h);
  const float n = ldf(n_ + row * ldres + h), hnv = ldf(hn + row * H + h);
  const float ag = ldf(agg + row * ldres + h);
  const float dn = g * (1.f - z);
  const float dz = g * (ag - n);
  const float dpre_n = dn * (1.f - n * n);
  const float dr = dpre_n * hnv;
  const float dpre_z = dz * z * (1.f - z);
  const float dpre_r = dr * r * (1.f - r);
  T* gi = dgi + row * 3 * H;
  T* gh = dgh + row * 3 * H;
  gi[h] = cvt<T>(dpre_r);
  gi[H + h] = cvt<T>(dpre_z);
  gi[2 * H + h] = cvt<T>(dpre_n);
  gh[h] = cvt<T>(dpre_r);
  gh[H + h] = cvt<T>(dpre_z);
  gh[2 * H + h] = cvt<T>(dpre_n * r);
  gz[row * H + h] = g * z;
}

// ------------------------------------------------------- K2/K4: NN GEMM
// A layer's two input-grad GEMMs in one launch, C[m, j] = sum_k A[m, k]
// B[k, j] with K = 3H: block z = 2 d + which, direction d of GEMM_BLOCKS;
// which 0: dagg [Kn, H] = round(dgh w_hh + gz), in the compute type;
// which 1: dcur [Kn, Din] = dgi w_ih, f32. grid (ceil(max(H, Din)/32),
// ceil(Kn/32), 2 nblk); a block past its GEMM's N returns. bf16: the
// tensor-core tile (B [K, N] read with ldmatrix.trans); float32: the
// CUDA-core tile.
template <typename T>
__device__ __forceinline__ void gemm_nn_out(int which, int Kn, int N, int m, int j, size_t r0,
                                            float acc, T* dagg, const float* gz, float* dcur) {
  if (m >= Kn || j >= N) return;
  const size_t o = (r0 + m) * N + j;
  if (which) dcur[o] = acc;
  else dagg[o] = cvt<T>(acc + gz[o]);
}

template <typename T, bool ASYNC>
__global__ void __launch_bounds__(NT) gemm_nn_kernel(int nb0, int Kn, int H, int Din,
                                                     const T* dgh, const T* whh_all, T* dagg,
                                                     const float* gz, const T* dgi,
                                                     const T* wih_all, float* dcur) {
  const int d = blockIdx.z >> 1, which = blockIdx.z & 1;
  const int N = which ? Din : H, K = 3 * H;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  if (n0 >= N) return;
  const size_t r0 = (size_t)(nb0 + d) * Kn;
  const T* Ad = (which ? dgi : dgh) + r0 * K;
  const T* B = (which ? wih_all : whh_all) + (size_t)d * K * N;
  if constexpr (std::is_same<T, bf16>::value) {
    __shared__ __align__(16) TcSmem<TK_NN> sm;
    float acc[2][4];
    tc_gemm<TK_NN, false, true, ASYNC>(sm, Ad, K, B, N, Kn, N, K, m0, n0, acc);
#pragma unroll
    for (int nb = 0; nb < 2; ++nb)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        gemm_nn_out<T>(which, Kn, N, m0 + tc_row(i, threadIdx.x),
                       n0 + tc_col(nb, i, threadIdx.x), r0, acc[nb][i], dagg,
                       gz, dcur);
  } else {
    __shared__ float sA[BM][BK + 1];
    __shared__ float sB[BK][BN + 1];
    const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k0 = 0; k0 < K; k0 += BK) {
      load_tile<T>(sA, Ad, K, Kn, K, m0, k0);
      load_tile<T>(sB, B, N, K, N, k0, n0);
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < BK; ++kk) {
        const float bv = sB[kk][tx];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i] += sA[ty + 8 * i][kk] * bv;
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      gemm_nn_out<T>(which, Kn, N, m0 + ty + 8 * i, n0 + tx, r0, acc[i], dagg, gz, dcur);
  }
}

// where a block's edge-value grads go: edges e < kv to dvals rows vo+e,
// intra-pair edges to dnear rows eo+e (summed over nsrc by seg_merge)
template <typename T>
__device__ __forceinline__ T* dvrow(const Blk& b, int e, T* dvals, int lddv, T* dnear,
                                    int lddn) {
  return e < b.kv ? dvals + (size_t)(b.vo + e) * lddv : dnear + (size_t)(b.eo + e) * lddn;
}

// ---------------------------------------------------- K2/K4: attention VJP
// grid (Kn, nblk), block 128. Owns destination slot n: dvals and dea of
// its edges, dq added into gnext (the f32 dcur buffer), dx on the last
// layer, and per-slot partials of the score / encoder weight grads:
//   part[row*W + ...] = [dwq (Dq) | dwk (H) | db (1) | dwe (H*R) | dbe (H)]
template <typename T>
__global__ void attn_bwd_kernel(Tab tb, int Kn, int H, int Dq, int R, int first, int last,
                                const T* dagg, const T* q, int ldq, Vals<T> vs,
                                const T* ea, const int* edst_all, const float* emask_all,
                                const float* a32, int lda32,
                                const T* wqr_all, const T* wkr_all,
                                const T* we_all, const T* be_all,
                                float* gnext, T* dx, T* dvals, int lddv, T* dnear, int lddn,
                                float* dea_acc, T* dea, float* part) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Blk b = pick(tb, blockIdx.y);
  const T** vp = reinterpret_cast<const T**>(smem);
  int* lst = reinterpret_cast<int*>(vp + b.ke);
  float* dal = reinterpret_cast<float*>(lst + b.ke);
  __shared__ int s_cnt;
  __shared__ float s_dqs;
  const int n = blockIdx.x, d = b.dir;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nw = blockDim.x >> 5;
  const int* edst = edst_all + b.eo;
  const float* emask = emask_all + b.eo;
  const T* wqr = wqr_all + (size_t)d * Dq;
  const T* wkr = wkr_all + (size_t)d * H;
  const T* we = we_all ? we_all + (size_t)d * H * R : nullptr;
  const T* be = be_all ? be_all + (size_t)d * H : nullptr;
  const size_t row = (size_t)b.nb * Kn + n;
  const int W = Dq + H + 1 + H * R + H;
  float* pt = part + row * W;

  // pad edges receive zero grads: edge e's row is written by the thread
  // block of slot e mod Kn, its threads across h (coalesced)
  for (int e = n; e < b.ke; e += gridDim.x) {
    if (edge_valid(edst, emask, e, Kn)) continue;
    const size_t er = (size_t)b.eo + e;
    T* dv = dvrow(b, e, dvals, lddv, dnear, lddn);
    for (int h = tid; h < H; h += blockDim.x) dv[h] = cvt<T>(0.f);
    if (ea && tid < R) {
      if (first) dea_acc[er * R + tid] = 0.f;
      if (last) dea[er * R + tid] = cvt<T>(dea_acc[er * R + tid]);
    }
  }
  if (warp == 0) {
    const int c = build_list(edst, emask, b.ke, n, lst);
    if (lane == 0) s_cnt = c;
  }
  __syncthreads();
  const int m = s_cnt;
  for (int j = tid; j < m; j += blockDim.x) vp[j] = vrow<T>(b, lst[j], Kn, vs);
  __syncthreads();
  const T* dg = dagg + row * H;
  for (int j = warp; j < m; j += nw) {
    const T* v = vp[j];
    float s = 0.f;
    for (int h = lane; h < H; h += 32) s += rnd<T>(ldf(dg + h) * ldz(v, h));
    s = warp_sum(s);
    if (lane == 0) dal[j] = s;
  }
  __syncthreads();
  if (tid == 0) {
    float sdot = 0.f;
    for (int j = 0; j < m; ++j)
      sdot += rnd<T>(a32[((size_t)b.eo + lst[j]) * lda32] * dal[j]);
    const float sd = rnd<T>(sdot);
    float dqs = 0.f, db = 0.f;
    for (int j = 0; j < m; ++j) {
      dal[j] = rnd<T>(a32[((size_t)b.eo + lst[j]) * lda32] * (dal[j] - sd));
      dqs += dal[j];
      db += dal[j];
    }
    s_dqs = rnd<T>(dqs);
    pt[Dq + H] = db;
  }
  __syncthreads();
  const float dqs = s_dqs;
  for (int h = tid; h < H; h += blockDim.x) {
    const float gr = ldf(dg + h), wk_h = ldf(wkr + h), be_h = be ? ldf(be + h) : 0.f;
    float pwk = 0.f, pbe = 0.f, pwe[MAXR];
    for (int r = 0; r < MAXR; ++r) pwe[r] = 0.f;
    for (int j = 0; j < m; ++j) {
      const int e = lst[j];
      const size_t er = (size_t)b.eo + e;
      const float vv = ldz(vp[j], h);
      const float al = rnd<T>(a32[er * lda32]);
      const float dv = rnd<T>(al * gr);
      const float dk = rnd<T>(dal[j] * wk_h);
      dvrow(b, e, dvals, lddv, dnear, lddn)[h] = cvt<T>(dv + dk);
      float k = vv;
      if (ea) {
        float enc = 0.f;
        for (int r = 0; r < R; ++r) enc += ldf(ea + er * R + r) * ldf(we + h * R + r);
        k = rnd<T>((vv + enc) + be_h);
        pbe += dk;
        for (int r = 0; r < R; ++r) pwe[r] += dk * ldf(ea + er * R + r);
      }
      pwk += k * dal[j];
    }
    pt[Dq + h] = pwk;
    for (int r = 0; r < R; ++r) pt[Dq + H + 1 + h * R + r] = ea ? pwe[r] : 0.f;
    pt[Dq + H + 1 + H * R + h] = pbe;
  }
  for (int k = tid; k < Dq; k += blockDim.x) {
    const float g = gnext[row * Dq + k] + dqs * ldf(wqr + k);
    if (last) dx[row * Dq + k] = cvt<T>(g);
    else gnext[row * Dq + k] = g;
    pt[k] = ldf(q + row * ldq + k) * dqs;
  }
  if (ea) {
    for (int j = warp; j < m; j += nw) {
      const size_t er = (size_t)b.eo + lst[j];
      for (int r = 0; r < R; ++r) {
        float s = 0.f;
        for (int h = lane; h < H; h += 32) s += rnd<T>(dal[j] * ldf(wkr + h)) * ldf(we + h * R + r);
        s = warp_sum(s);
        if (lane == 0) {
          const float x = rnd<T>(s);
          const float acc = first ? x : dea_acc[er * R + r] + x;
          dea_acc[er * R + r] = acc;
          if (last) dea[er * R + r] = cvt<T>(acc);
        }
      }
    }
  }
}

// ------------------------------------------------ K2/K4: weight-grad GEMM
// dW[j, k] += sum_m A[m, j] X[m, k] for (A, X) = (dgi, cur) -> w_ih and
// (dgh, agg) -> w_hh. grid (ceil(max(Din,H)/BN), ceil(3H/BM), 2*nblk),
// block z>>1 of GEMM_BLOCKS.
// bf16: the tensor-core tile, the sum over slots as its K (dgi/dgh read
// [m, j] and X [m, k], both with ldmatrix.trans); float32: the CUDA-core
// tile. Each dW element is added by the one tile that owns it.
template <typename T, bool ASYNC>
__global__ void __launch_bounds__(NT) wgrad_kernel(int nb0, int Kn, int H, int Din,
                                                   const T* dgi, const T* dgh,
                                                   const T* cur, int ldc, const T* agg, int ldg,
                                                   float* dwih, float* dwhh) {
  const int d = blockIdx.z >> 1, which = blockIdx.z & 1;
  const int K = which ? H : Din;
  const int k0 = blockIdx.x * BN, j0 = blockIdx.y * BM;
  if (k0 >= K) return;
  const int J = 3 * H;
  const size_t r0 = (size_t)(nb0 + d) * Kn;
  const T* A = (which ? dgh : dgi) + r0 * J;
  const T* X = which ? agg + r0 * ldg : cur + r0 * ldc;
  const size_t ldx = which ? ldg : ldc;
  float* dW = (which ? dwhh : dwih) + (size_t)d * J * K;
  if constexpr (std::is_same<T, bf16>::value) {
    __shared__ __align__(16) TcSmem<TK_WG> sm;
    float acc[2][4];
    tc_gemm<TK_WG, true, true, ASYNC>(sm, A, J, X, ldx, J, K, Kn, j0, k0, acc);
#pragma unroll
    for (int nb = 0; nb < 2; ++nb)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = j0 + tc_row(i, threadIdx.x), k = k0 + tc_col(nb, i, threadIdx.x);
        if (j < J && k < K) dW[(size_t)j * K + k] += acc[nb][i];
      }
  } else {
    __shared__ float sA[BK][BM + 1];
    __shared__ float sX[BK][BN + 1];
    const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int m0 = 0; m0 < Kn; m0 += BK) {
      load_tile<T>(sA, A, J, Kn, J, m0, j0);
      load_tile<T>(sX, X, ldx, Kn, K, m0, k0);
      __syncthreads();
#pragma unroll 8
      for (int mm = 0; mm < BK; ++mm) {
        const float x = sX[mm][tx];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i] += sA[mm][ty + 8 * i] * x;
      }
      __syncthreads();
    }
    const int k = k0 + tx;
    if (k >= K) return;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = j0 + ty + 8 * i;
      if (j < J) dW[(size_t)j * K + k] += acc[i];
    }
  }
}

// ------------------------------------- K2/K4: score weights and GRU biases
// grid (ceil(C/32), nblk), C = W + 6H columns, block (32, SR_G): sums over
// the Kn slots and adds into the f32 weight-grad accumulators. Column c =
// 32 x + tx; thread row ty sums slots ty, ty + SR_G, ... in order, then
// the SR_G partials are added in order ty = 0, 1, ...: a fixed order, no
// atomics (one thread a column walking all Kn slots, 26 blocks a
// direction, took 22 us on the H100). Block y of GEMM_BLOCKS.
#define SR_G 8

template <typename T>
__global__ void __launch_bounds__(32 * SR_G) small_reduce_kernel(
    int nb0, int Kn, int H, int Dq, int R, const float* part, const T* dgi, const T* dgh,
    float* dwq, float* dwk, float* db, float* dwe, float* dbe, float* dbih, float* dbhh) {
  __shared__ float red[SR_G][33];
  const int d = blockIdx.y, tx = threadIdx.x, ty = threadIdx.y;
  const size_t r0 = (size_t)(nb0 + d) * Kn;
  const int W = Dq + H + 1 + H * R + H;
  const int c = blockIdx.x * 32 + tx;
  const bool in_part = c < W, live = c < W + 6 * H;
  const bool hh = c - W >= 3 * H;
  const int jj = hh ? c - W - 3 * H : c - W;
  const T* A = (hh ? dgh : dgi) + r0 * 3 * H;
  float s = 0.f;
  if (live) {
    if (in_part)
      for (int n = ty; n < Kn; n += SR_G) s += part[(r0 + n) * W + c];
    else
      for (int n = ty; n < Kn; n += SR_G) s += ldf(A + (size_t)n * 3 * H + jj);
  }
  red[ty][tx] = s;
  __syncthreads();
  if (ty != 0 || !live) return;
  s = red[0][tx];
#pragma unroll
  for (int g = 1; g < SR_G; ++g) s += red[g][tx];
  if (!in_part) (hh ? dbhh : dbih)[(size_t)d * 3 * H + jj] += s;
  else if (c < Dq) dwq[(size_t)d * Dq + c] += s;
  else if (c < Dq + H) dwk[(size_t)d * H + c - Dq] += s;
  else if (c == Dq + H) db[d] += s;
  else if (c < Dq + H + 1 + H * R) { if (dwe) dwe[(size_t)d * H * R + c - Dq - H - 1] += s; }
  else { if (dbe) dbe[(size_t)d * H + c - Dq - H - 1 - H * R] += s; }
}

// ------------------------------------------------------------ C interface
// dtype: 0 float32, 1 bfloat16. tab: nblk * TABW host ints (Blk's fields in
// order); the GEMM_BLOCKS entries take nb0 instead. Every entry returns
// cudaGetLastError(), or cudaErrorInvalidValue for blocks it cannot run.

#define P(T, x) static_cast<const T*>(x)
#define PM(T, x) static_cast<T*>(x)

// Read a host table.
static bool read_tab(const int* t, int nblk, Tab* tb, int* kemax, int* ktmax) {
  if (nblk < 1 || nblk > MAXB) return false;
  *kemax = *ktmax = 0;
  for (int i = 0; i < nblk; ++i) {
    const int* r = t + i * TABW;
    tb->b[i] = Blk{r[0], r[1], r[2], r[3], r[4], r[5], r[6], r[7], r[8]};
    if (tb->b[i].ke > *kemax) *kemax = tb->b[i].ke;
    if (tb->b[i].kt > *ktmax) *ktmax = tb->b[i].kt;
  }
  return true;
}

static bool al16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }
static bool al8(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 7) == 0; }

// attn_fwd over a table's blocks: V = 4 value columns a lane when H, the
// leading dimensions and the pointers allow 4-element loads, else one
template <typename T>
static void launch_attn_fwd(const Tab& tb, int nblk, int kemax, int Kn, int H, int Dq, int R,
                            const void* q, int ldq, const void* val, int ldv, const int* nsrc,
                            const void* src, int lds, const void* ea, const int* edst,
                            const float* emask, const void* wq, const void* wk, const void* b,
                            const void* we, const void* be, float* a32, int lda32, void* agg,
                            int ldagg, cudaStream_t st) {
  const size_t smem = (size_t)kemax * (sizeof(T*) + 2 * sizeof(int)) +
                      (size_t)H * (R + 2) * sizeof(float);
  const auto alv = [](const void* p) { return sizeof(T) == 2 ? al8(p) : al16(p); };
  const bool vec = H % 4 == 0 && ldv % 4 == 0 && lds % 4 == 0 && ldagg % 4 == 0 && alv(val) &&
                   alv(src) && alv(agg);
  auto k = vec ? attn_fwd_kernel<T, 4> : attn_fwd_kernel<T, 1>;
  smem_opt_in(k, smem, sizeof(int) * SM_CHUNK);
  Vals<T> vs{P(T, val), ldv, nsrc, P(T, src), lds};
  k<<<dim3(Kn, nblk), AF_THREADS, smem, st>>>(tb, Kn, H, Dq, R, P(T, q), ldq, vs, P(T, ea), edst,
                                             emask, P(T, wq), P(T, wk), P(T, b), P(T, we),
                                             P(T, be), a32, lda32, PM(T, agg), ldagg, kemax);
}

extern "C" int wf_attn_fwd(int dtype, const int* tab, int nblk, int Kn, int H, int Dq, int R,
                           const void* q, int ldq, const void* val, int ldv, const int* nsrc,
                           const void* src, int lds, const void* ea, const int* edst,
                           const float* emask, const void* wq, const void* wk, const void* b,
                           const void* we, const void* be, float* a32, int lda32, void* agg,
                           int ldagg, void* stream) {
  Tab tb;
  int kemax, ktmax;
  if (R > MAXR || !read_tab(tab, nblk, &tb, &kemax, &ktmax)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    launch_attn_fwd<float>(tb, nblk, kemax, Kn, H, Dq, R, q, ldq, val, ldv, nsrc, src, lds, ea,
                           edst, emask, wq, wk, b, we, be, a32, lda32, agg, ldagg, st);
  else
    launch_attn_fwd<bf16>(tb, nblk, kemax, Kn, H, Dq, R, q, ldq, val, ldv, nsrc, src, lds, ea,
                          edst, emask, wq, wk, b, we, be, a32, lda32, agg, ldagg, st);
  return (int)cudaGetLastError();
}

extern "C" int wf_gru_fwd(int dtype, int nb0, int nblk, int Kn, int H, int Din,
                          const void* cur, int ldc, const void* agg, int ldg, const void* wih,
                          const void* whh, const void* brz, const void* bin, const void* bhn,
                          const float* nmask, void* out, int ldo, void* r, void* z, void* n,
                          int ldres, void* stream) {
  if (nblk < 1 || nblk > MAXB) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid((H + BN - 1) / BN, (Kn + BM - 1) / BM, nblk);
  if (dtype == 0) {
    gru_fwd_kernel<float, false><<<grid, NT, 0, st>>>(
        nb0, Kn, H, Din, P(float, cur), ldc, P(float, agg), ldg, P(float, wih), P(float, whh),
        P(float, brz), P(float, bin), P(float, bhn), nmask, PM(float, out), ldo, PM(float, r),
        PM(float, z), PM(float, n), ldres);
  } else {
    const bool al = H % 4 == 0 && Din % 4 == 0 && ldc % 4 == 0 && ldg % 4 == 0 && al8(cur) &&
                    al8(agg) && al8(wih) && al8(whh);
    auto k = al ? gru_fwd_kernel<bf16, true> : gru_fwd_kernel<bf16, false>;
    const size_t smem = sizeof(GruStage) * 2 * GRU_STAGES;
    smem_opt_in(k, smem);
    k<<<grid, GRU_THREADS, smem, st>>>(nb0, Kn, H, Din, P(bf16, cur), ldc, P(bf16, agg), ldg,
                                   P(bf16, wih), P(bf16, whh), P(bf16, brz), P(bf16, bin),
                                   P(bf16, bhn), nmask, PM(bf16, out), ldo, PM(bf16, r),
                                   PM(bf16, z), PM(bf16, n), ldres);
  }
  return (int)cudaGetLastError();
}

// seg_merge over a table's blocks: 16-byte columns when L*H and every
// row pointer allow them, else one column a lane
template <typename T>
static void launch_seg_merge(const Tab& tb, int nblk, int Kn, int LH, int src_at_vo,
                             const void* g, const void* src, const int* idx,
                             const float* mask, const void* gadd, float* gtot, void* gout,
                             cudaStream_t st) {
  const dim3 grid(Kn, nblk), block(SM_WPS * 32);
  const bool vec = LH % 8 == 0 && al16(g) && al16(src) && al16(gadd) && al16(gtot) && al16(gout);
  if (vec)
    seg_merge_kernel<T, 8><<<grid, block, 0, st>>>(
        tb, Kn, LH, src_at_vo, P(T, g), P(T, src), idx, mask, P(T, gadd), gtot, PM(T, gout));
  else
    seg_merge_kernel<T, 1><<<grid, block, 0, st>>>(
        tb, Kn, LH, src_at_vo, P(T, g), P(T, src), idx, mask, P(T, gadd), gtot, PM(T, gout));
}

extern "C" int wf_seg_merge(int dtype, const int* tab, int nblk, int Kn, int LH, int src_at_vo,
                            const void* g, const void* src, const int* idx, const float* mask,
                            const void* gadd, float* gtot, void* gout, void* stream) {
  Tab tb;
  int kemax, ktmax;
  if (!read_tab(tab, nblk, &tb, &kemax, &ktmax)) return (int)cudaErrorInvalidValue;
  if (!gtot && !gout) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    launch_seg_merge<float>(tb, nblk, Kn, LH, src_at_vo, g, src, idx, mask, gadd, gtot, gout, st);
  else
    launch_seg_merge<bf16>(tb, nblk, Kn, LH, src_at_vo, g, src, idx, mask, gadd, gtot, gout, st);
  return (int)cudaGetLastError();
}

// K5: out [Kn, LH] = g + the masked sum of tg [Kt, LH] rows over tdst, in
// f32, rounded to the compute type (one block of Kn slots).
extern "C" int wf_tg_accumulate(int dtype, int Kn, int LH, int Kt, const void* g,
                                const void* tg, const int* tdst, const float* tmask,
                                void* out, void* stream) {
  if (Kn < 1 || Kt < 0) return (int)cudaErrorInvalidValue;
  Tab tb{};
  tb.b[0] = Blk{0, 0, 0, 0, 0, 0, 0, Kt, -1};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    launch_seg_merge<float>(tb, 1, Kn, LH, 0, g, tg, tdst, tmask, nullptr, nullptr, out, st);
  else
    launch_seg_merge<bf16>(tb, 1, Kn, LH, 0, g, tg, tdst, tmask, nullptr, nullptr, out, st);
  return (int)cudaGetLastError();
}

extern "C" int wf_rebuild(int dtype, const int* tab, int nblk, int Kn, int H, const void* agg,
                          const void* z, const void* n, int ldres, const void* whh,
                          const void* bhh, const float* nmask, void* hn, void* cur_out,
                          int ldo, void* stream) {
  Tab tb;
  int kemax, ktmax;
  if (!read_tab(tab, nblk, &tb, &kemax, &ktmax)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid((H + BN - 1) / BN, (Kn + BM - 1) / BM, nblk);
  if (dtype == 0) {
    rebuild_kernel<float, false><<<grid, NT, 0, st>>>(tb, Kn, H, P(float, agg), P(float, z),
                                                      P(float, n), ldres, P(float, whh),
                                                      P(float, bhh), nmask, PM(float, hn),
                                                      PM(float, cur_out), ldo);
  } else {
    auto k = (ldres % 4 == 0 && H % 4 == 0 && al8(agg) && al8(whh)) ? rebuild_kernel<bf16, true>
                                                                     : rebuild_kernel<bf16, false>;
    k<<<grid, TC_THREADS, 0, st>>>(tb, Kn, H, P(bf16, agg), P(bf16, z), P(bf16, n), ldres,
                                   P(bf16, whh), P(bf16, bhh), nmask, PM(bf16, hn),
                                   PM(bf16, cur_out), ldo);
  }
  return (int)cudaGetLastError();
}

extern "C" int wf_gru_bwd_elem(int dtype, int nb0, int nblk, int Kn, int H,
                               const float* gtot, int ldgt, const float* gnext,
                               const float* nmask, const void* agg, const void* r,
                               const void* z, const void* n, int ldres, const void* hn,
                               void* dgi, void* dgh, float* gz, void* stream) {
  if (nblk < 1 || nblk > MAXB) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int total = nblk * Kn * H;
  const int blocks = (total + 255) / 256;
  if (dtype == 0)
    gru_bwd_elem_kernel<float><<<blocks, 256, 0, st>>>(
        nb0, total, Kn, H, gtot, ldgt, gnext, nmask, P(float, agg), P(float, r), P(float, z),
        P(float, n), ldres, P(float, hn), PM(float, dgi), PM(float, dgh), gz);
  else
    gru_bwd_elem_kernel<bf16><<<blocks, 256, 0, st>>>(
        nb0, total, Kn, H, gtot, ldgt, gnext, nmask, P(bf16, agg), P(bf16, r), P(bf16, z),
        P(bf16, n), ldres, P(bf16, hn), PM(bf16, dgi), PM(bf16, dgh), gz);
  return (int)cudaGetLastError();
}

// A layer's dagg = round(dgh w_hh + gz) and dcur = dgi w_ih, one launch
extern "C" int wf_gemm_nn(int dtype, int nb0, int nblk, int Kn, int H, int Din,
                          const void* dgh, const void* whh, void* dagg, const float* gz,
                          const void* dgi, const void* wih, float* dcur, void* stream) {
  if (nblk < 1 || nblk > MAXB) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nmax = H > Din ? H : Din;
  dim3 grid((nmax + BN - 1) / BN, (Kn + BM - 1) / BM, 2 * nblk);
  if (dtype == 0) {
    gemm_nn_kernel<float, false><<<grid, NT, 0, st>>>(nb0, Kn, H, Din, P(float, dgh),
                                                      P(float, whh), PM(float, dagg), gz,
                                                      P(float, dgi), P(float, wih), dcur);
  } else {
    const bool al = H % 4 == 0 && Din % 4 == 0 && al8(dgh) && al8(dgi) && al8(whh) && al8(wih);
    auto k = al ? gemm_nn_kernel<bf16, true> : gemm_nn_kernel<bf16, false>;
    k<<<grid, TC_THREADS, 0, st>>>(nb0, Kn, H, Din, P(bf16, dgh), P(bf16, whh), PM(bf16, dagg),
                                   gz, P(bf16, dgi), P(bf16, wih), dcur);
  }
  return (int)cudaGetLastError();
}

template <typename T>
static void launch_attn_bwd(const Tab& tb, int nblk, int kemax, int Kn, int H, int Dq, int R,
                            int first, int last, const void* dagg, const void* q, int ldq,
                            const void* val, int ldv, const int* nsrc, const void* src, int lds,
                            const void* ea, const int* edst, const float* emask,
                            const float* a32, int lda32, const void* wqr, const void* wkr,
                            const void* we, const void* be, float* gnext, void* dx,
                            void* dvals, int lddv, void* dnear, int lddn, float* dea_acc,
                            void* dea, float* part, cudaStream_t st) {
  const size_t smem = (size_t)kemax * (sizeof(T*) + 2 * sizeof(int));
  smem_opt_in(attn_bwd_kernel<T>, smem);
  Vals<T> vs{P(T, val), ldv, nsrc, P(T, src), lds};
  attn_bwd_kernel<T><<<dim3(Kn, nblk), 128, smem, st>>>(
      tb, Kn, H, Dq, R, first, last, P(T, dagg), P(T, q), ldq, vs, P(T, ea), edst, emask, a32,
      lda32, P(T, wqr), P(T, wkr), P(T, we), P(T, be), gnext, PM(T, dx), PM(T, dvals), lddv,
      PM(T, dnear), lddn, dea_acc, PM(T, dea), part);
}

extern "C" int wf_attn_bwd(int dtype, const int* tab, int nblk, int Kn, int H, int Dq, int R,
                           int first, int last, const void* dagg, const void* q, int ldq,
                           const void* val, int ldv, const int* nsrc, const void* src, int lds,
                           const void* ea, const int* edst, const float* emask,
                           const float* a32, int lda32, const void* wqr, const void* wkr,
                           const void* we, const void* be, float* gnext, void* dx,
                           void* dvals, int lddv, void* dnear, int lddn, float* dea_acc,
                           void* dea, float* part, void* stream) {
  Tab tb;
  int kemax, ktmax;
  if (R > MAXR || !read_tab(tab, nblk, &tb, &kemax, &ktmax))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    launch_attn_bwd<float>(tb, nblk, kemax, Kn, H, Dq, R, first, last, dagg, q, ldq, val, ldv,
                           nsrc, src, lds, ea, edst, emask, a32, lda32, wqr, wkr, we, be,
                           gnext, dx, dvals, lddv, dnear, lddn, dea_acc, dea, part, st);
  else
    launch_attn_bwd<bf16>(tb, nblk, kemax, Kn, H, Dq, R, first, last, dagg, q, ldq, val, ldv,
                          nsrc, src, lds, ea, edst, emask, a32, lda32, wqr, wkr, we, be,
                          gnext, dx, dvals, lddv, dnear, lddn, dea_acc, dea, part, st);
  return (int)cudaGetLastError();
}

extern "C" int wf_wgrad(int dtype, int nb0, int nblk, int Kn, int H, int Din,
                        const void* dgi, const void* dgh, const void* cur, int ldc,
                        const void* agg, int ldg, float* dwih, float* dwhh, void* stream) {
  if (nblk < 1 || nblk > MAXB) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int kmax = Din > H ? Din : H;
  dim3 grid((kmax + BN - 1) / BN, (3 * H + BM - 1) / BM, 2 * nblk);
  if (dtype == 0) {
    wgrad_kernel<float, false><<<grid, NT, 0, st>>>(nb0, Kn, H, Din, P(float, dgi),
                                                    P(float, dgh), P(float, cur), ldc,
                                                    P(float, agg), ldg, dwih, dwhh);
  } else {
    const bool al = H % 4 == 0 && Din % 4 == 0 && ldc % 4 == 0 && ldg % 4 == 0 && al8(dgi) &&
                    al8(dgh) && al8(cur) && al8(agg);
    auto k = al ? wgrad_kernel<bf16, true> : wgrad_kernel<bf16, false>;
    k<<<grid, TC_THREADS, 0, st>>>(nb0, Kn, H, Din, P(bf16, dgi), P(bf16, dgh), P(bf16, cur),
                                   ldc, P(bf16, agg), ldg, dwih, dwhh);
  }
  return (int)cudaGetLastError();
}

extern "C" int wf_small_reduce(int dtype, int nb0, int nblk, int Kn, int H, int Dq,
                               int R, const float* part, const void* dgi, const void* dgh,
                               float* dwq, float* dwk, float* db, float* dwe, float* dbe,
                               float* dbih, float* dbhh, void* stream) {
  if (nblk < 1 || nblk > MAXB) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int C = Dq + H + 1 + H * R + H + 6 * H;
  dim3 grid((C + 31) / 32, nblk), block(32, SR_G);
  if (dtype == 0)
    small_reduce_kernel<float><<<grid, block, 0, st>>>(nb0, Kn, H, Dq, R, part, P(float, dgi),
                                                       P(float, dgh), dwq, dwk, db, dwe, dbe,
                                                       dbih, dbhh);
  else
    small_reduce_kernel<bf16><<<grid, block, 0, st>>>(nb0, Kn, H, Dq, R, part, P(bf16, dgi),
                                                      P(bf16, dgh), dwq, dwk, db, dwe, dbe,
                                                      dbih, dbhh);
  return (int)cudaGetLastError();
}
