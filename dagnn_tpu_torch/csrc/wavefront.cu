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
//    600, bf16), 0.37 us at 3.35 TB/s: memory bound; one thread block per
//    slot, columns across threads, reads coalesced along L*H. Measured on
//    an H100 (chip_smoke.py phase 3d, device time from a CUDA graph):
//    9.7 us, against 5.6 us for index_add_ on the same data: warp 0's
//    ballot scan of all Kt entries per slot is the serial part.
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
// output), and for K2/K4 a transpose-grad merge, a state rebuild, and per
// layer and group an elementwise GRU VJP, two GEMMs, an attention VJP, a
// weight-grad GEMM and a bias/score weight reduction. K4 runs group B first,
// then sums B's intra-pair value grads over nsrc into A's cotangent with the
// same merge kernel (a second index source), then runs group A.
//
// Translation from the TPU kernel: no one-hot matrices. A segment op is an
// indexed loop: one thread block per (block, destination slot) scans the
// block's edge list in order (warp ballots keep the order, so every sum runs
// in a fixed order) and owns that slot's softmax, aggregate and score
// gradients. The GRU products are shared-memory tiled GEMMs with float32
// accumulation and the gate math fused into their epilogue. Weight
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
// bound on paper (a few us each). This first version runs its GEMMs on the
// CUDA cores in float32 (no tensor cores), so it is bound by float32 FMA
// throughput instead; wgmma/TMA tiles are later work.

#include "common.cuh"

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

// ------------------------------------------------------- K1/K3: attention
// grid (Kn, nblk), block 128. Scores, segment softmax and aggregate of one
// destination slot; writes alpha32 (optional) and agg. Dynamic shared
// memory: ke value-row pointers, ke edge ids, ke scores.
template <typename T>
__global__ void attn_fwd_kernel(Tab tb, int Kn, int H, int Dq, int R,
                                const T* q, int ldq, Vals<T> vs,
                                const T* ea, const int* edst_all, const float* emask_all,
                                const T* wq_all, const T* wk_all, const T* b_all,
                                const T* we_all, const T* be_all,
                                float* a32, int lda32, T* agg, int ldagg) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Blk b = pick(tb, blockIdx.y);
  const T** vp = reinterpret_cast<const T**>(smem);
  int* lst = reinterpret_cast<int*>(vp + b.ke);
  float* sc = reinterpret_cast<float*>(lst + b.ke);
  __shared__ int s_cnt;
  __shared__ float s_red[32];
  const int n = blockIdx.x, d = b.dir;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nw = blockDim.x >> 5;
  const int* edst = edst_all + b.eo;
  const float* emask = emask_all + b.eo;
  const T* wq = wq_all + (size_t)d * Dq;
  const T* wk = wk_all + (size_t)d * H;
  const T* we = we_all ? we_all + (size_t)d * H * R : nullptr;
  const T* be = be_all ? be_all + (size_t)d * H : nullptr;
  const float bias = ldf(b_all + d);
  const size_t row = (size_t)b.nb * Kn + n;

  if (n == 0 && a32)
    for (int e = tid; e < b.ke; e += blockDim.x)
      if (!edge_valid(edst, emask, e, Kn)) a32[(size_t)(b.eo + e) * lda32] = 0.f;
  if (warp == 0) {
    const int c = build_list(edst, emask, b.ke, n, lst);
    if (lane == 0) s_cnt = c;
  }
  float p = 0.f;
  for (int k = tid; k < Dq; k += blockDim.x) p += ldf(q + row * ldq + k) * ldf(wq + k);
  p = warp_sum(p);
  if (lane == 0) s_red[warp] = p;
  __syncthreads();
  const int m = s_cnt;
  for (int j = tid; j < m; j += blockDim.x) vp[j] = vrow<T>(b, lst[j], Kn, vs);
  __syncthreads();
  for (int j = warp; j < m; j += nw) {
    const size_t er = (size_t)b.eo + lst[j];
    const T* v = vp[j];
    float s = 0.f;
    for (int h = lane; h < H; h += 32) {
      float kk = ldz(v, h);
      if (ea) {
        float enc = 0.f;
        for (int r = 0; r < R; ++r) enc += ldf(ea + er * R + r) * ldf(we + h * R + r);
        kk = rnd<T>((kk + enc) + ldf(be + h));
      }
      s += kk * ldf(wk + h);
    }
    s = warp_sum(s);
    if (lane == 0) sc[j] = s + bias;
  }
  __syncthreads();
  if (tid == 0) {
    float qs = 0.f;
    for (int w = 0; w < nw; ++w) qs += s_red[w];
    qs = rnd<T>(qs);
    float mx = -FLT_MAX;
    for (int j = 0; j < m; ++j) { sc[j] = qs + sc[j]; mx = fmaxf(mx, sc[j]); }
    if (mx <= -FLT_MAX) mx = 0.f;
    const float smd = rnd<T>(mx);
    float den = 0.f;
    for (int j = 0; j < m; ++j) { sc[j] = expf(sc[j] - smd); den += rnd<T>(sc[j]); }
    const float dd = rnd<T>(den) + 1e-16f;
    for (int j = 0; j < m; ++j) {
      const float al = sc[j] / dd;
      if (a32) a32[(size_t)(b.eo + lst[j]) * lda32] = al;
      sc[j] = rnd<T>(al);
    }
  }
  __syncthreads();
  for (int h = tid; h < H; h += blockDim.x) {
    float s = 0.f;
    for (int j = 0; j < m; ++j) s += rnd<T>(ldz(vp[j], h) * sc[j]);
    agg[row * ldagg + h] = cvt<T>(s);
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

// ------------------------------------------------------------- K1/K3: GRU
// grid (ceil(H/BN), ceil(Kn/BM), nblk), block 256. out = GRU(cur, agg),
// r/z/n residuals optional. Thread (ty, tx): hidden unit h0+tx, rows
// m0+ty+8i. Block z: direction z, node block nb0 + z (see GEMM_BLOCKS).
template <typename T>
__global__ void __launch_bounds__(NT) gru_fwd_kernel(
    int nb0, int Kn, int H, int Din, const T* cur, int ldc, const T* agg, int ldg,
    const T* wih_all, const T* whh_all, const T* brz_all, const T* bin_all,
    const T* bhn_all, const float* nmask, T* out, int ldo, T* rr, T* zz, T* nn,
    int ldres) {
  __shared__ float sA[BM][BK + 1];
  __shared__ float sW[3][BN][BK + 1];
  const int d = blockIdx.z, h0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const size_t r0 = (size_t)(nb0 + d) * Kn;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const T* wih = wih_all + (size_t)d * 3 * H * Din;
  const T* whh = whh_all + (size_t)d * 3 * H * H;
  const T* curd = cur + r0 * ldc;
  const T* aggd = agg + r0 * ldg;
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
  const int h = h0 + tx;
  if (h >= H) return;
  const float brr = ldf(brz_all + (size_t)d * 2 * H + h);
  const float bzz = ldf(brz_all + (size_t)d * 2 * H + H + h);
  const float bi = ldf(bin_all + (size_t)d * H + h);
  const float bh = ldf(bhn_all + (size_t)d * H + h);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 8 * i;
    if (m >= Kn) continue;
    const size_t row = r0 + m;
    const float r = sigm(acc[i][0] + brr);
    const float z = sigm(acc[i][1] + bzz);
    const float hn = acc[i][3] + bh;
    const float n = tanhf((acc[i][2] + bi) + r * hn);
    const float zd = rnd<T>(z), nd = rnd<T>(n);
    const float ag = ldf(agg + row * ldg + h);
    out[row * ldo + h] = cvt<T>(gru_combine(zd, nd, ag, nmask[row]));
    if (rr) {
      rr[row * ldres + h] = cvt<T>(r);
      zz[row * ldres + h] = cvt<T>(z);
      nn[row * ldres + h] = cvt<T>(n);
    }
  }
}

// ------------------------------------------------ K2/K4/K5/K7: seg merge
// grid (Kn, nblk), block 128: base + (the sum of src rows over the list
// entries [to, to+kt) whose idx is slot n (mask set), plus gadd's row if
// given), in f32. The list's src rows start at row `to`, or with
// src_at_vo at row `vo` (K7's near-grad merge, whose grads and indices lie
// at different offsets). base is g (K2/K4's transpose-grad merge, K7's
// adding the next row's near grads as gadd, and K5: src tg, idx tdst),
// gtot itself with g null (K4's intra-pair merge: src the B blocks'
// intra-pair value grads, idx nsrc, list = B_d's intra-pair range, node
// block A_d), or 0 with both null (K7's near-grad merge: src the near
// edges' value grads, idx nsrc). The sum goes to the f32 gtot, or with
// gout set (K5, K7) to gout rounded to T.
template <typename T>
__global__ void seg_merge_kernel(Tab tb, int Kn, int LH, int src_at_vo, const T* g,
                                 const T* src, const int* idx, const float* mask,
                                 const T* gadd, float* gtot, T* gout) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* lst = reinterpret_cast<int*>(smem);
  __shared__ int s_cnt;
  const Blk b = pick(tb, blockIdx.y);
  const int n = blockIdx.x;
  if ((threadIdx.x >> 5) == 0) {
    const int c = build_list(idx + b.to, mask + b.to, b.kt, n, lst);
    if ((threadIdx.x & 31) == 0) s_cnt = c;
  }
  __syncthreads();
  const int m = s_cnt;
  const size_t row = (size_t)b.nb * Kn + n;
  const size_t so = src_at_vo ? b.vo : b.to;
  for (int c = threadIdx.x; c < LH; c += blockDim.x) {
    float s = 0.f;
    for (int j = 0; j < m; ++j) s += ldf(src + (so + lst[j]) * LH + c);
    if (gadd) s += ldf(gadd + row * LH + c);
    const float base = g ? ldf(g + row * LH + c) : gtot ? gtot[row * LH + c] : 0.f;
    if (gout) gout[row * LH + c] = cvt<T>(base + s);
    else gtot[row * LH + c] = base + s;
  }
}

// --------------------------------------------------------- K2/K4: rebuild
// grid (ceil(H/BN), ceil(Kn/BM), nblk), block 256: h_n = agg w_hn^T + b_hn
// (rounded), and the layer output rebuilt from the residuals (optional).
template <typename T>
__global__ void __launch_bounds__(NT) rebuild_kernel(
    Tab tb, int Kn, int H, const T* agg, const T* z, const T* nres_n, int ldres,
    const T* whh_all, const T* bhh_all, const float* nmask, T* hn, T* cur_out, int ldo) {
  __shared__ float sA[BM][BK + 1];
  __shared__ float sW[BN][BK + 1];
  const Blk b = pick(tb, blockIdx.z);
  const int d = b.dir, h0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const size_t r0 = (size_t)b.nb * Kn;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const T* whn = whh_all + (size_t)d * 3 * H * H + (size_t)2 * H * H;
  const T* aggd = agg + r0 * ldres;
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
  if (h >= H) return;
  const float bb = ldf(bhh_all + (size_t)d * 3 * H + 2 * H + h);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 8 * i;
    if (m >= Kn) continue;
    const size_t row = r0 + m;
    hn[row * H + h] = cvt<T>(acc[i] + bb);
    if (cur_out) {
      const float zd = ldf(z + row * ldres + h), nd = ldf(nres_n + row * ldres + h);
      const float ag = ldf(agg + row * ldres + h);
      cur_out[row * ldo + h] = cvt<T>(gru_combine(zd, nd, ag, nmask[row]));
    }
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
// C[m, j] = sum_k A[m, k] B[k, j]; A [Kn, K] (compute type, per node
// block), B a weight [K, N] per direction. mode 0: C f32; mode 1: C in the
// compute type = round(acc + gz[m, j]). grid (ceil(N/BN), ceil(Kn/BM), nblk),
// block z of GEMM_BLOCKS.
template <typename T>
__global__ void __launch_bounds__(NT) gemm_nn_kernel(int nb0, int Kn, int N, int K, const T* A,
                                                     const T* B_all, int mode, void* C,
                                                     const float* gz) {
  __shared__ float sA[BM][BK + 1];
  __shared__ float sB[BK][BN + 1];
  const int d = blockIdx.z, n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const size_t r0 = (size_t)(nb0 + d) * Kn;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const T* Ad = A + r0 * K;
  const T* B = B_all + (size_t)d * K * N;
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
  const int j = n0 + tx;
  if (j >= N) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 8 * i;
    if (m >= Kn) continue;
    const size_t o = (r0 + m) * N + j;
    if (mode == 0) static_cast<float*>(C)[o] = acc[i];
    else static_cast<T*>(C)[o] = cvt<T>(acc[i] + gz[o]);
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
template <typename T>
__global__ void __launch_bounds__(NT) wgrad_kernel(int nb0, int Kn, int H, int Din,
                                                   const T* dgi, const T* dgh,
                                                   const T* cur, int ldc, const T* agg, int ldg,
                                                   float* dwih, float* dwhh) {
  __shared__ float sA[BK][BM + 1];
  __shared__ float sX[BK][BN + 1];
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

// ------------------------------------- K2/K4: score weights and GRU biases
// grid (ceil(C/128), nblk), C = W + 6H columns: sums over the Kn slots in
// order and adds into the f32 weight-grad accumulators. Block y of
// GEMM_BLOCKS.
template <typename T>
__global__ void small_reduce_kernel(int nb0, int Kn, int H, int Dq, int R, const float* part,
                                    const T* dgi, const T* dgh,
                                    float* dwq, float* dwk, float* db, float* dwe,
                                    float* dbe, float* dbih, float* dbhh) {
  const int d = blockIdx.y;
  const size_t r0 = (size_t)(nb0 + d) * Kn;
  const int W = Dq + H + 1 + H * R + H;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= W + 6 * H) return;
  float s = 0.f;
  if (c < W) {
    for (int n = 0; n < Kn; ++n) s += part[(r0 + n) * W + c];
    if (c < Dq) dwq[(size_t)d * Dq + c] += s;
    else if (c < Dq + H) dwk[(size_t)d * H + c - Dq] += s;
    else if (c == Dq + H) db[d] += s;
    else if (c < Dq + H + 1 + H * R) { if (dwe) dwe[(size_t)d * H * R + c - Dq - H - 1] += s; }
    else { if (dbe) dbe[(size_t)d * H + c - Dq - H - 1 - H * R] += s; }
    return;
  }
  const int j = c - W;
  const bool hh = j >= 3 * H;
  const int jj = hh ? j - 3 * H : j;
  const T* A = (hh ? dgh : dgi) + r0 * 3 * H;
  for (int m = 0; m < Kn; ++m) s += ldf(A + (size_t)m * 3 * H + jj);
  (hh ? dbhh : dbih)[(size_t)d * 3 * H + jj] += s;
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

template <typename T>
static void launch_attn_fwd(const Tab& tb, int nblk, int kemax, int Kn, int H, int Dq, int R,
                            const void* q, int ldq, const void* val, int ldv, const int* nsrc,
                            const void* src, int lds, const void* ea, const int* edst,
                            const float* emask, const void* wq, const void* wk, const void* b,
                            const void* we, const void* be, float* a32, int lda32, void* agg,
                            int ldagg, cudaStream_t st) {
  const size_t smem = (size_t)kemax * (sizeof(T*) + 2 * sizeof(int));
  smem_opt_in(attn_fwd_kernel<T>, smem);
  Vals<T> vs{P(T, val), ldv, nsrc, P(T, src), lds};
  attn_fwd_kernel<T><<<dim3(Kn, nblk), 128, smem, st>>>(
      tb, Kn, H, Dq, R, P(T, q), ldq, vs, P(T, ea), edst, emask, P(T, wq), P(T, wk), P(T, b),
      P(T, we), P(T, be), a32, lda32, PM(T, agg), ldagg);
}

extern "C" int wf_attn_fwd(int dtype, const int* tab, int nblk, int Kn, int H, int Dq, int R,
                           const void* q, int ldq, const void* val, int ldv, const int* nsrc,
                           const void* src, int lds, const void* ea, const int* edst,
                           const float* emask, const void* wq, const void* wk, const void* b,
                           const void* we, const void* be, float* a32, int lda32, void* agg,
                           int ldagg, void* stream) {
  Tab tb;
  int kemax, ktmax;
  if (!read_tab(tab, nblk, &tb, &kemax, &ktmax)) return (int)cudaErrorInvalidValue;
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
  if (dtype == 0)
    gru_fwd_kernel<float><<<grid, NT, 0, st>>>(
        nb0, Kn, H, Din, P(float, cur), ldc, P(float, agg), ldg, P(float, wih), P(float, whh),
        P(float, brz), P(float, bin), P(float, bhn), nmask, PM(float, out), ldo, PM(float, r),
        PM(float, z), PM(float, n), ldres);
  else
    gru_fwd_kernel<bf16><<<grid, NT, 0, st>>>(
        nb0, Kn, H, Din, P(bf16, cur), ldc, P(bf16, agg), ldg, P(bf16, wih), P(bf16, whh),
        P(bf16, brz), P(bf16, bin), P(bf16, bhn), nmask, PM(bf16, out), ldo, PM(bf16, r),
        PM(bf16, z), PM(bf16, n), ldres);
  return (int)cudaGetLastError();
}

extern "C" int wf_seg_merge(int dtype, const int* tab, int nblk, int Kn, int LH, int src_at_vo,
                            const void* g, const void* src, const int* idx, const float* mask,
                            const void* gadd, float* gtot, void* gout, void* stream) {
  Tab tb;
  int kemax, ktmax;
  if (!read_tab(tab, nblk, &tb, &kemax, &ktmax)) return (int)cudaErrorInvalidValue;
  if (!gtot && !gout) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid(Kn, nblk);
  const size_t smem = (size_t)ktmax * sizeof(int);
  if (dtype == 0) {
    smem_opt_in(seg_merge_kernel<float>, smem);
    seg_merge_kernel<float><<<grid, 128, smem, st>>>(tb, Kn, LH, src_at_vo, P(float, g),
                                                     P(float, src), idx, mask, P(float, gadd),
                                                     gtot, PM(float, gout));
  } else {
    smem_opt_in(seg_merge_kernel<bf16>, smem);
    seg_merge_kernel<bf16><<<grid, 128, smem, st>>>(tb, Kn, LH, src_at_vo, P(bf16, g),
                                                    P(bf16, src), idx, mask, P(bf16, gadd),
                                                    gtot, PM(bf16, gout));
  }
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
  const size_t smem = (size_t)Kt * sizeof(int);
  if (dtype == 0) {
    smem_opt_in(seg_merge_kernel<float>, smem);
    seg_merge_kernel<float><<<dim3(Kn, 1), 128, smem, st>>>(
        tb, Kn, LH, 0, P(float, g), P(float, tg), tdst, tmask, nullptr, nullptr,
        PM(float, out));
  } else {
    smem_opt_in(seg_merge_kernel<bf16>, smem);
    seg_merge_kernel<bf16><<<dim3(Kn, 1), 128, smem, st>>>(
        tb, Kn, LH, 0, P(bf16, g), P(bf16, tg), tdst, tmask, nullptr, nullptr,
        PM(bf16, out));
  }
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
  if (dtype == 0)
    rebuild_kernel<float><<<grid, NT, 0, st>>>(tb, Kn, H, P(float, agg), P(float, z),
                                               P(float, n), ldres, P(float, whh),
                                               P(float, bhh), nmask, PM(float, hn),
                                               PM(float, cur_out), ldo);
  else
    rebuild_kernel<bf16><<<grid, NT, 0, st>>>(tb, Kn, H, P(bf16, agg), P(bf16, z),
                                              P(bf16, n), ldres, P(bf16, whh), P(bf16, bhh),
                                              nmask, PM(bf16, hn), PM(bf16, cur_out), ldo);
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

extern "C" int wf_gemm_nn(int dtype, int nb0, int nblk, int Kn, int N, int K,
                          const void* A, const void* B, int mode, void* C, const float* gz,
                          void* stream) {
  if (nblk < 1 || nblk > MAXB) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid((N + BN - 1) / BN, (Kn + BM - 1) / BM, nblk);
  if (dtype == 0)
    gemm_nn_kernel<float><<<grid, NT, 0, st>>>(nb0, Kn, N, K, P(float, A), P(float, B), mode, C,
                                               gz);
  else
    gemm_nn_kernel<bf16><<<grid, NT, 0, st>>>(nb0, Kn, N, K, P(bf16, A), P(bf16, B), mode, C,
                                              gz);
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
  if (dtype == 0)
    wgrad_kernel<float><<<grid, NT, 0, st>>>(nb0, Kn, H, Din, P(float, dgi), P(float, dgh),
                                             P(float, cur), ldc, P(float, agg), ldg, dwih,
                                             dwhh);
  else
    wgrad_kernel<bf16><<<grid, NT, 0, st>>>(nb0, Kn, H, Din, P(bf16, dgi), P(bf16, dgh),
                                            P(bf16, cur), ldc, P(bf16, agg), ldg, dwih, dwhh);
  return (int)cudaGetLastError();
}

extern "C" int wf_small_reduce(int dtype, int nb0, int nblk, int Kn, int H, int Dq,
                               int R, const float* part, const void* dgi, const void* dgh,
                               float* dwq, float* dwk, float* db, float* dwe, float* dbe,
                               float* dbih, float* dbhh, void* stream) {
  if (nblk < 1 || nblk > MAXB) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int C = Dq + H + 1 + H * R + H + 6 * H;
  dim3 grid((C + 127) / 128, nblk);
  if (dtype == 0)
    small_reduce_kernel<float><<<grid, 128, 0, st>>>(nb0, Kn, H, Dq, R, part, P(float, dgi),
                                                     P(float, dgh), dwq, dwk, db, dwe, dbe,
                                                     dbih, dbhh);
  else
    small_reduce_kernel<bf16><<<grid, 128, 0, st>>>(nb0, Kn, H, Dq, R, part, P(bf16, dgi),
                                                    P(bf16, dgh), dwq, dwk, db, dwe, dbe, dbih,
                                                    dbhh);
  return (int)cudaGetLastError();
}
