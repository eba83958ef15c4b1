// The backward of multi-head attention on [B, T, D] activations with
// attention-weight dropout, for NVIDIA Hopper (sm_90a): the training
// attention's gradient only. Its forward (with dropout), the sampling
// attention and the [B, H, T, hd] attention run the tensor-core forward of
// attention_fwd.cu.
//
// Replaces the backward of the TPU kernel fused_attention_btd_train
// (custom_vjp _attn_train, body _train_bwd_kernel :415, math in
// _softmax_chunk and _apply_dropout) in regennet_tpu/ops/pallas_attention.py,
// and computes
// what it computes:
//   * heads are column slices of D; q is scaled by 1/sqrt(hd) in the input
//     dtype before QK; scores accumulate in f32 and are rounded to the
//     score dtype (the input dtype unless softmax_f32); causal and/or
//     kv_len masks; softmax as max, exp, sum, divide in the score dtype;
//   * from (q, k, v, seeds) and dO only (nothing [B,H,T,T] is saved):
//     dV = (P.M)^T dO with the forward's dropped weights (P in v's dtype,
//     kept ones times 1/(1-rate) in that dtype); dP = (dO V^T).M with an
//     f32 keep-scale; dS = P (dP - rowsum(dP P)) in f32 on the undropped P,
//     rounded to q's dtype; dQ = scale dS K and dK = scale dS^T Q with the
//     unscaled Q and the f32 scale, each rounded once.
// The mask M is the forward's: both draw it with attention_math.cuh's
// Philox (a weight is kept iff its bits are >= threshold).
//
// What bounds it on an H100 (f32, B=64, T=150, D=512, causal):
// 7*B*T*D*4 = 137.6 MB (41 us at 3.35 TB/s) against 10*B*pairs*D = 3.71
// GFLOP (55 us at 67 TF/s f32): operations. The row pass alone moves q, k,
// v, dO and dQ (98.3 MB, 29 us) and needs QK^T, dO V^T and dS K (33 us);
// the column pass moves q, k, v, dO, dK and dV (118 MB, 35 us) and needs
// QK^T, dO V^T, dV and dK (44 us). At the text CMDM's 197 tokens (f32 B=64,
// D=512, non-causal) the row pass needs 7.63 GFLOP: 114 us, operations.
//
// Design: two deterministic passes, no atomics.
//   1. The row pass, one block per (query tile, head, batch), writes dQ and
//      each row's softmax max and sum (score dtype) and D_i = sum_j dP_ij
//      P_ij (f32) to a [3, B, H, T] buffer. Rows of up to 160 keys (the
//      training shapes of the Chi3D models: T = 150, 151 tokens offline,
//      NTU 60) take attention_train_rows: attention_fwd.cu's block of 4
//      warps per 64-query tile, each warp owning 16 rows, built from the
//      warp-level pieces of attention_mma.cuh (bf16 mma.sync, or the 3xTF32
//      split for f32). The scores (for bf16 with a bf16 softmax summed by
//      FMAs in the column pass's order, so that both passes round them
//      alike: scores_fma) and the exact two-pass softmax stay in the
//      accumulators (P rounded to the score dtype), the keep mask is drawn
//      into registers while q and the keys load, and dP = dO V^T is
//      computed a group of 32 keys at a time, twice: once for D, once to
//      overwrite P in place with dS. That is four products for the
//      function's three, with no second key-wide array in registers (P
//      alone takes 80 registers a lane at 160 keys). dQ = dS K is the
//      forward's W V with K in V's place. Operands stay in the input dtype
//      in shared memory: q (then dO) beside a slab of keys (then values) of
//      as many rows as keep two blocks an SM; K loads again, over the whole
//      region, for dQ (from L2).
//      Longer rows (the text CMDM's 197 tokens: train_mdm --dataset humanml
//      or kit, every layer) take attention_train_rows_stored, the same block
//      and the same products with the block's rows of P in shared memory in
//      place of registers, as the TPU kernel holds whole rows of P in VMEM:
//      scores a chunk of at most 160 keys at a time, masked and rounded in
//      the accumulators and stored as they are (each lane its own
//      fragments: no transposes, no bank conflicts), the row max across the
//      chunks; a sweep for the exact softmax with the final max (the bf16
//      softmax needs it before any exponent, so no online rescaling), which
//      also draws the keep mask while dO and the values load and keeps it
//      in the stored weights' signs; dP per group of 32 keys twice (D, then
//      dS in place); dQ with dS reloaded as the A operand, 128 columns of
//      dQ in registers over one pass of K. Four products, none recomputed
//      per chunk (the forward's three-pass scheme would make seven). At
//      f32 [64, 197, 512] 64 rows of P take 57 KB (224 keys) beside 34 KB
//      of q: a slab of 32 keys keeps two blocks an SM; longer rows narrow
//      the block to 32, then 16 rows of P. The longest rows it takes are
//      those whose 16 rows of P, 16 rows of q and one group of keys fit in
//      227 KB: 3,232 keys at f32 hd 128 (2,848 at hd 256), 6,848 at bf16
//      with a bf16 softmax (6,464), 3,424 with an f32 one (3,232); longer
//      rows return cudaErrorInvalidValue.
//   2. The column pass, attention_train_cols, the row pass on its side: one
//      block of 4 warps per (head, batch, tile of 64 keys), each warp owning
//      16 keys as the mma rows, walks the query slabs that can see its keys
//      (from the tile's first key on under the causal mask; the key tile is
//      the grid's slowest index, so the long tiles launch first). Per group
//      of 32 queries it recomputes S^T = K (scale q)^T (for bf16 with a bf16
//      softmax by scores_fma, the row pass's sums bit for bit), P from the
//      row statistics at the row pass's rounding points, dP^T = V dO^T and
//      the keep mask (drawn while the slab loads), then dV += W dO and dK +=
//      dS q as the forward's W V, with dK and dV for 128 head-dim columns
//      in registers across the slabs (wider heads take a sweep per 128).
//      Keys and values stay in shared memory for the whole walk, beside a
//      slab of q and dO (bf16: and a scaled copy of q; f32 scales q as its
//      fragments are built), two blocks an SM at hd 128.
// q, k and v may be strided views (columns of one packed [B, T, 3D]
// projection): only the last dimension must be contiguous. dO, dQ, dK and
// dV take the strides in RowArgs.so*.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

#include "attention_mma.cuh"

namespace {

constexpr int MAX_HD = 256;  // largest head dim a launch takes

// the tensor-core row pass
constexpr int ROW_WARPS = 4;
constexpr int ROW_THREADS = 32 * ROW_WARPS;
constexpr int ROW_QT = 16 * ROW_WARPS;  // query rows of a block

// the column pass (the row pass's block): keys of a block, 16 a warp (the
// head-dim columns of dK and dV that a sweep over the queries holds in
// registers: COL_HD)
constexpr int COL_KT = 16 * ROW_WARPS;

struct RowArgs {
  int seq, heads, hd;
  // strides in elements of q, k, v (batch, head, row) and of the output,
  // which dO, dQ, dK and dV share
  long long sqb, sqh, sqt, skb, skh, skt, svb, svh, svt, sob, soh, sot;
  float scale_q;    // scales q before QK, rounded to the input dtype
  float scale_f32;  // 1/sqrt(hd) in f32 (scales dQ and dK)
  int causal, klimit, softmax_f32;
  // the tensor-core row pass: hd padded to a multiple of 16, the copy width
  // in bytes (16, 8, 4, or 2 for bf16), the keys of a shared slab, and the
  // query rows of a block of the stored-row route (64, 32 or 16)
  int hdp, copy_bytes, kslab, qt;
};

// The scores of a warp's rows for the groups of 32 keys that start in
// [lo, hi) (layout of s and arguments as WarpMma::scores): one FMA a step
// of d, in order, on the bf16 values widened to f32. Both passes take this
// for bf16 with a bf16 softmax, the column pass with keys as the warp's rows
// and queries as the slab (an FMA's product commutes: the same bits). There
// each score is rounded to bf16, and mma.sync's f32 sums (exact products,
// an accumulation that is not IEEE's) round to the other side of a bf16
// boundary often enough that the row pass's P and statistics would disagree
// with the column pass's P, a flip changing a weight by 1.5-3% through
// exp().
template <int NB>
__device__ __forceinline__ void scores_fma(float (&s)[NB][4], int lo, int hi,
                                           const __nv_bfloat16* q, const __nv_bfloat16* k,
                                           int ld, int hdp) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const __nv_bfloat16* q0 = q + g * ld;
  const __nv_bfloat16* q1 = q + (g + 8) * ld;
  auto pair = [](const __nv_bfloat16* x) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(x));
  };
#pragma unroll
  for (int gi = 0; gi < NB / 4; ++gi) {
    if (gi * GROUP >= lo && gi * GROUP < hi) {
      const __nv_bfloat16* kg = k + (gi * GROUP + 2 * t) * ld;
#pragma unroll 1
      for (int d = 0; d < hdp; d += 2) {  // (the zero padding past hd adds exact zeros)
        const float2 a = pair(q0 + d), b = pair(q1 + d);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const float2 k0 = pair(kg + 8 * jj * ld + d), k1 = pair(kg + (8 * jj + 1) * ld + d);
          float (&c)[4] = s[4 * gi + jj];
          c[0] = fmaf(a.y, k0.y, fmaf(a.x, k0.x, c[0]));
          c[1] = fmaf(a.y, k1.y, fmaf(a.x, k1.x, c[1]));
          c[2] = fmaf(b.y, k0.y, fmaf(b.x, k0.x, c[2]));
          c[3] = fmaf(b.y, k1.y, fmaf(b.x, k1.x, c[3]));
        }
      }
    }
  }
}

// dP = dO V^T of the warp's rows for the groups of 32 keys that start in
// [lo, hi), from values whose row 0 is key 0, with the mask and the f32
// keep-scale; then D += dP P (SECOND false), or P <- dS = P (dP - D)
// rounded to T (SECOND true). dP is rounded before the subtraction, as the
// plain version's two steps round it.
template <typename T, bool SECOND, int NB>
__device__ __forceinline__ void dp_groups(float (&s)[NB][4], float (&dsum)[2],
                                          const KeepMask<NB>& keep, float keep_f32, int lo,
                                          int hi, const T* dout, const T* values, int ld,
                                          int hdp) {
#pragma unroll
  for (int gi = 0; gi < NB / 4; ++gi) {
    if (gi * GROUP >= lo && gi * GROUP < hi) {
      asm volatile("" ::: "memory");  // keep each group's loads in the group
      float c[4][4] = {};
      WarpMma<T, NB>::group(c, dout, values + gi * GROUP * ld, ld, hdp);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = 4 * gi + jj;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool kept = keep.w[j / 8] >> (4 * (j % 8) + e) & 1u;
          const float dp = kept ? __fmul_rn(c[jj][e], keep_f32) : 0.f;
          if (SECOND)
            s[j][e] = round_to<T>(s[j][e] * (dp - dsum[e >> 1]));
          else
            dsum[e >> 1] += dp * s[j][e];
        }
      }
    }
  }
}

// Backward row pass on tensor cores, for rows of at most KC keys: reads dO
// and writes dQ (both in the output strides) and stats [3, B, H, T] (row
// max, row sum, D_i). grid: (ceil(seq / ROW_QT), heads, batch); ROW_THREADS
// threads; dynamic shared memory (ROW_QT + p.kslab) rows of tile_ld(hdp)
// elements (q, then dO; beside them a slab of p.kslab keys, then values;
// for dQ the keys over the whole region), then the loads' mbarrier.
template <typename T, int KC, bool SF32>
__global__ void __launch_bounds__(ROW_THREADS, 2)
attention_train_rows(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, T* __restrict__ dq, float* __restrict__ stats,
                     const int* __restrict__ seed, int seed_per_row, uint32_t threshold,
                     float keep_f32, const RowArgs p) {
  constexpr int NB = KC / 8;
  using Mma = WarpMma<T, NB>;
  constexpr int DC = Mma::DC;
  using Score = typename std::conditional<SF32, float, T>::type;  // the score dtype
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = tile_ld(p.hdp, sizeof(T));
  const int whole = ROW_QT + p.kslab;       // rows of the region
  T* as = reinterpret_cast<T*>(smem_raw);  // [ROW_QT][ld] scaled q, then dO
  T* bs = as + ROW_QT * ld;                 // [kslab][ld] keys, then values

  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const int q0 = blockIdx.x * ROW_QT;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int rows = min(ROW_QT, p.seq - q0);
  const int kmax = p.causal ? min(p.klimit, q0 + rows) : p.klimit;  // keys the tile sees
  const int row0 = q0 + 16 * warp;  // the warp's first query row
  const bool active = row0 < p.seq;
  const int wmax = p.causal ? min(kmax, row0 + 16) : kmax;  // keys the warp sees
  const int lim[2] = {p.causal ? min(p.klimit, row0 + g + 1) : p.klimit,
                      p.causal ? min(p.klimit, row0 + g + 9) : p.klimit};
  const T* wa = as + 16 * warp * ld;
  const Dropout drop = make_dropout(seed, seed_per_row, b, threshold, 1.f, keep_f32);
  Loader<T, ROW_THREADS> loads{reinterpret_cast<uint64_t*>(as + whole * ld), 0u, ld, p.hd,
                               p.copy_bytes};

  const T* qb = q + b * p.sqb + h * p.sqh + (long long)q0 * p.sqt;
  const T* kb = k + b * p.skb + h * p.skh;
  const T* vb = v + b * p.svb + h * p.svh;
  const long long ob = b * p.sob + h * p.soh;  // this (batch, head) in dO / dQ

  // rows [first, first + n) of src into dst, and zeros up to a whole group
  // (the products read whole groups; zero weights must meet finite values)
  auto load_slab = [&](T* dst, const T* src, long long stride, int first, int n) {
    const int padded = (n + GROUP - 1) / GROUP * GROUP;
    if (padded > n) zero_rows<ROW_THREADS>(dst, ld, n, padded, p.hdp);
    loads.issue(dst, src + first * stride, stride, n);
  };

  // q and the first slab of keys; the keep mask while they load
  if (threadIdx.x == 0) mbar_init(loads.bar);
  zero_cols<ROW_THREADS>(as, ld, whole, p.hd, p.hdp);
  if (rows < ROW_QT) zero_rows<ROW_THREADS>(as, ld, rows, ROW_QT, p.hdp);  // stays zero for dO
  __syncthreads();
  loads.issue(as, qb, p.sqt, rows);
  load_slab(bs, kb, p.skt, 0, min(p.kslab, kmax));
  KeepMask<NB> keep;
  if (drop.threshold) {
    keep = keep_mask<NB>(drop, h, row0, p.seq, 0, lim, wmax);
  } else {
#pragma unroll
    for (int wi = 0; wi < (NB + 7) / 8; ++wi) keep.w[wi] = ~0u;
  }
  loads.wait();
  __syncthreads();
  scale_rows<ROW_THREADS>(as, as, ld, rows, p.hdp, p.scale_q);
  int held = 0;  // the first key of the slab in bs

  // the scores, rounded and masked, slab by slab
  float s[NB][4];
#pragma unroll
  for (int j = 0; j < NB; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
  for (int a = 0; a < kmax; a += p.kslab) {
    if (a != held) {
      __syncthreads();
      load_slab(bs, kb, p.skt, a, min(p.kslab, kmax - a));
      loads.wait();
      held = a;
    }
    __syncthreads();
    if constexpr (sizeof(T) == 2 && !SF32) {
      if (active) scores_fma<NB>(s, a, min(a + p.kslab, wmax), wa, bs - a * ld, ld, p.hdp);
    } else {
      if (active) Mma::scores(s, a, min(a + p.kslab, wmax), wa, bs - a * ld, ld, p.hdp);
    }
  }
  finish_scores<T, SF32>(s, 0, lim, wmax, 1.f);

  // q and the keys are consumed: dO and the first slab of values load
  // during the softmax
  __syncthreads();
  loads.issue(as, dout + ob + (long long)q0 * p.sot, p.sot, rows);
  load_slab(bs, vb, p.svt, 0, min(p.kslab, kmax));
  held = 0;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l[2] = {0.f, 0.f};
  row_max(s, m, wmax);
  reduce_max(m);
  exponentiate<T, SF32>(s, m, l, wmax);
  reduce_sum<T, SF32>(l);
  weights<Score>(s, l, wmax);  // P in the score dtype (the forward's are in T)
  // the statistics of the real rows, from lane t = 0 of each: m and l now,
  // D once the first dP pass has summed it
  const long long plane = (long long)gridDim.z * p.heads * p.seq;
  float* st = stats + (b * p.heads + h) * p.seq;
  if (t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = row0 + g + 8 * r;
      if (i < p.seq) {
        st[i] = m[r];
        st[plane + i] = l[r];
      }
    }
  }

  float dsum[2] = {0.f, 0.f};
  // the slab of values that starts at key a into bs, unless it is there
  auto values = [&](int a) {
    if (a != held) {
      __syncthreads();
      load_slab(bs, vb, p.svt, a, min(p.kslab, kmax - a));
      loads.wait();
      held = a;
    }
    __syncthreads();
  };

  loads.wait();  // dO and the first slab of values
  for (int a = 0; a < kmax; a += p.kslab) {
    values(a);
    if (active)
      dp_groups<T, false>(s, dsum, keep, drop.scale_f32, a, min(a + p.kslab, wmax), wa,
                          bs - a * ld, ld, p.hdp);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    dsum[r] += __shfl_xor_sync(0xffffffffu, dsum[r], 1);
    dsum[r] += __shfl_xor_sync(0xffffffffu, dsum[r], 2);
    const int i = row0 + g + 8 * r;
    if (t == 0 && i < p.seq) st[2 * plane + i] = dsum[r];
  }
  // the last slab of values is still in place: walk back from it
  for (int a = (kmax - 1) / p.kslab * p.kslab; a >= 0; a -= p.kslab) {
    values(a);
    if (active)
      dp_groups<T, true>(s, dsum, keep, drop.scale_f32, a, min(a + p.kslab, wmax), wa,
                         bs - a * ld, ld, p.hdp);
  }

  // dQ = scale dS K: the forward's W V with K in V's place, over the whole
  // region once dO and the values are consumed
  typename Mma::Weights w;
  Mma::pack(s, w);  // (dS is a value of T: packing it to bf16 is exact)
  const bool resident = kmax <= whole;
  __syncthreads();
  if (resident) {
    load_slab(as, kb, p.skt, 0, kmax);
    loads.wait();
    __syncthreads();
  }
  T* dqb = dq + ob;
#pragma unroll 1
  for (int dc = 0; dc < p.hdp; dc += DC) {
    float o[DC / 8][4] = {};
    for (int a = 0; a < kmax; a += whole) {
      if (!resident) {
        __syncthreads();
        load_slab(as, kb, p.skt, a, min(whole, kmax - a));
        loads.wait();
        __syncthreads();
      }
      if (active && dc + DC <= p.hdp)
        Mma::template weighted_sum<true>(o, s, w, a, min(a + whole, wmax), as - a * ld, ld, dc,
                                         p.hdp);
      else if (active)
        Mma::template weighted_sum<false>(o, s, w, a, min(a + whole, wmax), as - a * ld, ld, dc,
                                          p.hdp);
    }
#pragma unroll
    for (int n = 0; n < DC / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] *= p.scale_f32;
    if (active) store_rows<T, DC>(o, dqb, p.sot, row0, p.seq, dc, p.hd);
  }
}

// Backward row pass on tensor cores for rows of more than MAX_KC keys:
// attention_train_rows with the block's rows of P in shared memory
// (put_block) in place of registers. Reads dO and writes dQ (both in the
// output strides) and stats [3, B, H, T] (row max, row sum, D_i). grid:
// (ceil(seq / p.qt), heads, batch); ROW_THREADS threads, the first p.qt /
// 16 warps owning 16 rows each (the others help load); dynamic shared
// memory stored_rows_smem: (p.qt + p.kslab) rows of tile_ld(hdp) elements
// (q, then dO; beside them a slab of p.kslab keys, then values; for dQ the
// keys over the whole region), each warp's rows of P ([kp / 8][32][4] in
// the score dtype, kp the keys rounded up to a group), then the loads'
// mbarrier.
template <typename T, bool SF32>
__global__ void __launch_bounds__(ROW_THREADS, 2)
attention_train_rows_stored(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, const T* __restrict__ dout,
                            T* __restrict__ dq, float* __restrict__ stats,
                            const int* __restrict__ seed, int seed_per_row, uint32_t threshold,
                            float keep_f32, const RowArgs p) {
  constexpr int NB = MAX_KC / 8;  // a chunk of scores in registers
  using Mma = WarpMma<T, NB>;
  using Group = WarpMma<T, 4>;  // one group of 32 keys
  constexpr int DC = Mma::DC;
  constexpr int NC = COL_HD / DC;  // dQ's column blocks held over a pass of K
  using Score = typename std::conditional<SF32, float, T>::type;  // the score dtype
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = tile_ld(p.hdp, sizeof(T));
  const int kp = (p.klimit + GROUP - 1) / GROUP * GROUP;  // keys of a stored row
  const int whole = (p.qt + p.kslab) / GROUP * GROUP;     // keys of the region, for dQ
  T* as = reinterpret_cast<T*>(smem_raw);  // [qt][ld] scaled q, then dO
  T* bs = as + p.qt * ld;                   // [kslab][ld] keys, then values
  Score* ps = reinterpret_cast<Score*>(bs + p.kslab * ld);  // the warps' rows of P

  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const int q0 = blockIdx.x * p.qt;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int rows = min(p.qt, p.seq - q0);
  const int kmax = p.causal ? min(p.klimit, q0 + rows) : p.klimit;  // keys the tile sees
  const int row0 = q0 + 16 * warp;  // the warp's first query row
  const bool active = 16 * warp < p.qt && row0 < p.seq;
  const int wmax = p.causal ? min(kmax, row0 + 16) : kmax;  // keys the warp sees
  const int lim[2] = {p.causal ? min(p.klimit, row0 + g + 1) : p.klimit,
                      p.causal ? min(p.klimit, row0 + g + 9) : p.klimit};
  const T* wa = as + 16 * warp * ld;
  Score* pw = ps + 16 * warp * kp;
  const Dropout drop = make_dropout(seed, seed_per_row, b, threshold, 1.f, keep_f32);
  Loader<T, ROW_THREADS> loads{reinterpret_cast<uint64_t*>(ps + p.qt * kp), 0u, ld, p.hd,
                               p.copy_bytes};

  const T* qb = q + b * p.sqb + h * p.sqh + (long long)q0 * p.sqt;
  const T* kb = k + b * p.skb + h * p.skh;
  const T* vb = v + b * p.svb + h * p.svh;
  const long long ob = b * p.sob + h * p.soh;  // this (batch, head) in dO / dQ

  // rows [first, first + n) of src into dst, and zeros up to a whole group
  // (the products read whole groups; zero weights must meet finite values)
  auto load_slab = [&](T* dst, const T* src, long long stride, int first, int n) {
    const int padded = (n + GROUP - 1) / GROUP * GROUP;
    if (padded > n) zero_rows<ROW_THREADS>(dst, ld, n, padded, p.hdp);
    loads.issue(dst, src + first * stride, stride, n);
  };

  // q and the first slab of keys
  if (threadIdx.x == 0) mbar_init(loads.bar);
  zero_cols<ROW_THREADS>(as, ld, p.qt + p.kslab, p.hd, p.hdp);
  if (rows < p.qt) zero_rows<ROW_THREADS>(as, ld, rows, p.qt, p.hdp);  // stays zero for dO
  __syncthreads();
  loads.issue(as, qb, p.sqt, rows);
  load_slab(bs, kb, p.skt, 0, min(p.kslab, kmax));
  loads.wait();
  __syncthreads();
  scale_rows<ROW_THREADS>(as, as, ld, rows, p.hdp, p.scale_q);
  int held = 0;  // the first key of the slab in bs

  // the scores, rounded and masked, a chunk at a time into P; the row max
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
  for (int a = 0; a < kmax; a += p.kslab) {
    if (a != held) {
      __syncthreads();
      load_slab(bs, kb, p.skt, a, min(p.kslab, kmax - a));
      loads.wait();
      held = a;
    }
    __syncthreads();
    const int end = min(a + p.kslab, wmax);
#pragma unroll 1
    for (int c = a; active && c < end; c += MAX_KC) {
      const int n = min(MAX_KC, end - c);  // keys of the chunk the warp sees
      float s[NB][4];
#pragma unroll
      for (int j = 0; j < NB; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      if constexpr (sizeof(T) == 2 && !SF32)
        scores_fma<NB>(s, 0, n, wa, bs + (c - a) * ld, ld, p.hdp);
      else
        Mma::scores(s, 0, n, wa, bs + (c - a) * ld, ld, p.hdp);
      finish_scores<T, SF32>(s, c, lim, n, 1.f);
      row_max(s, m, n);
#pragma unroll
      for (int j = 0; j < NB; ++j)
        if (j / 4 * GROUP < n) put_block(pw, c / 8 + j, s[j]);
    }
  }

  // q and the keys are consumed: dO and the first slab of values load
  // during the softmax, which draws the keep mask
  __syncthreads();
  loads.issue(as, dout + ob + (long long)q0 * p.sot, p.sot, rows);
  load_slab(bs, vb, p.svt, 0, min(p.kslab, kmax));
  held = 0;
  reduce_max(m);
  float l[2] = {0.f, 0.f};
#pragma unroll 1
  for (int c = 0; active && c < wmax; c += GROUP) {
    float s[4][4];
    get_group(pw, c / 8, s);
    exponentiate<T, SF32>(s, m, l, GROUP);
    if (drop.threshold) mark_dropped(s, keep_mask<4>(drop, h, row0, p.seq, c, lim, GROUP));
    put_group(pw, c / 8, s);
  }
  reduce_sum<T, SF32>(l);
  // the statistics of the real rows, from lane t = 0 of each: m and l now,
  // D once the first dP pass has summed it
  const long long plane = (long long)gridDim.z * p.heads * p.seq;
  float* st = stats + (b * p.heads + h) * p.seq;
  if (active && t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = row0 + g + 8 * r;
      if (i < p.seq) {
        st[i] = m[r];
        st[plane + i] = l[r];
      }
    }
  }

  float dsum[2] = {0.f, 0.f};
  // the slab of values that starts at key a into bs, unless it is there
  auto values = [&](int a) {
    if (a != held) {
      __syncthreads();
      load_slab(bs, vb, p.svt, a, min(p.kslab, kmax - a));
      loads.wait();
      held = a;
    }
    __syncthreads();
  };

  // P = e / l in the score dtype (the forward's weights are in T), and D
  loads.wait();  // dO and the first slab of values
  for (int a = 0; a < kmax; a += p.kslab) {
    values(a);
    const int end = min(a + p.kslab, wmax);
#pragma unroll 1
    for (int c = a; active && c < end; c += GROUP) {
      float s[4][4];
      get_group(pw, c / 8, s);
      const KeepMask<4> keep = take_keep(s);
      weights<Score>(s, l, GROUP);
      dp_groups<T, false>(s, dsum, keep, drop.scale_f32, 0, 1, wa, bs + (c - a) * ld, ld,
                          p.hdp);
      mark_dropped(s, keep);
      put_group(pw, c / 8, s);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    dsum[r] += __shfl_xor_sync(0xffffffffu, dsum[r], 1);
    dsum[r] += __shfl_xor_sync(0xffffffffu, dsum[r], 2);
    const int i = row0 + g + 8 * r;
    if (active && t == 0 && i < p.seq) st[2 * plane + i] = dsum[r];
  }
  // dS over P in place; the last slab of values is still in place: walk
  // back from it
  for (int a = (kmax - 1) / p.kslab * p.kslab; a >= 0; a -= p.kslab) {
    values(a);
    const int end = min(a + p.kslab, wmax);
#pragma unroll 1
    for (int c = a; active && c < end; c += GROUP) {
      float s[4][4];
      get_group(pw, c / 8, s);
      const KeepMask<4> keep = take_keep(s);
      dp_groups<T, true>(s, dsum, keep, drop.scale_f32, 0, 1, wa, bs + (c - a) * ld, ld,
                         p.hdp);
      put_group(pw, c / 8, s);
    }
  }

  // dQ = scale dS K: the forward's W V with K in V's place and dS reloaded
  // a group at a time, over the whole region once dO and the values are
  // consumed; COL_HD columns of dQ in registers over one pass of K
  const bool resident = kmax <= whole;
  __syncthreads();
  if (resident) {
    load_slab(as, kb, p.skt, 0, kmax);
    loads.wait();
    __syncthreads();
  }
  T* dqb = dq + ob;
#pragma unroll 1
  for (int dh = 0; dh < p.hdp; dh += COL_HD) {
    float o[NC][DC / 8][4] = {};
    for (int a = 0; a < kmax; a += whole) {
      if (!resident) {
        __syncthreads();
        load_slab(as, kb, p.skt, a, min(whole, kmax - a));
        loads.wait();
        __syncthreads();
      }
      const int end = min(a + whole, wmax);
#pragma unroll 1
      for (int c = a; active && c < end; c += GROUP) {
        float s[4][4];
        get_group(pw, c / 8, s);
        typename Group::Weights w;
        Group::pack(s, w);  // (dS is a value of T: packing it to bf16 is exact)
        accumulate_group(o, s, w, as + (c - a) * ld, ld, dh, p.hdp);
      }
    }
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      const int dc = dh + n * DC;
      if (dc < p.hdp) {
#pragma unroll
        for (int x = 0; x < DC / 8; ++x)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[n][x][e] *= p.scale_f32;
        if (active) store_rows<T, DC>(o[n], dqb, p.sot, row0, p.seq, dc, p.hd);
      }
    }
  }
}

// whether query i sees key j
__device__ __forceinline__ bool sees(const RowArgs& p, int i, int j) {
  return i < p.seq && j < p.klimit && (!p.causal || j <= i);
}

// The dropout mask of a warp's weights in the column pass, keep_mask on its
// side: bit 16 gq + 4 jj + e keeps element e of query block jj of group gq
// of the slab, which is key kw + g + 8 (e >> 1) and query i0 + 32 gq + 8 jj +
// 2t + (e & 1) (the accumulator layout with the keys as rows). Weights that
// no query sees draw no bits.
template <int QS>
__device__ __forceinline__ uint32_t keep_mask_cols(const Dropout& d, int h, int kw, int i0,
                                                   const RowArgs& p) {
  static_assert(QS <= 64, "a slab's mask is one word");
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  uint32_t bits = 0u;
#pragma unroll 4
  for (int bit = 0; bit < QS / 2; ++bit) {
    const int e = bit & 3;
    const int i = i0 + 8 * (bit >> 2) + 2 * t + (e & 1), j = kw + g + 8 * (e >> 1);
    if (sees(p, i, j) && d.bits(h, i, j) >= d.threshold) bits |= 1u << bit;
  }
  return bits;
}

// The query slab: QS rows, of which f32 has room for one group of 32
// beside the keys and values at two blocks an SM, bf16 for two with a third
// copy (the scaled queries, which scores_fma reads); ROWS of shared tile in
// all.
template <typename T> struct ColSlab {
  static constexpr int QS = sizeof(T) == 4 ? 32 : 64;
  static constexpr bool COPY = sizeof(T) == 2;
  static constexpr int ROWS = 2 * COL_KT + (COPY ? 3 : 2) * QS;
};

template <typename T>
size_t col_smem_bytes(int hdp) {
  using S = ColSlab<T>;
  return (size_t)S::ROWS * tile_ld(hdp, sizeof(T)) * sizeof(T) + 4 * S::QS * sizeof(float) + 16;
}

// Backward column pass on tensor cores: dK and dV of one tile of COL_KT
// keys, each warp owning 16 keys as the mma rows, for every head dim up to
// MAX_HD in sweeps of COL_HD columns. Walks the query slabs that can see its
// keys (from the tile's first key on under the causal mask). Per group of 32
// queries: S^T = K (scale q)^T (bf16 with a bf16 softmax: scores_fma, the
// row pass's sums bit for bit; else mma), P from the row statistics at the
// row pass's rounding points, dP^T = V dO^T, dS^T and the dropped weights in
// place, then dV += W dO and dK += dS Q as the forward's W V.
// grid: (heads, batch, ceil(seq / COL_KT)), the key tile slowest so that
// the long tiles launch first; ROW_THREADS threads; dynamic shared memory
// col_smem_bytes: keys and values [COL_KT][ld], queries and dO [QS][ld]
// (bf16: and the scaled queries), the slab's statistics [4][QS] (max, sum,
// 1 / sum, D_i), then the loads' mbarrier.
template <typename T, bool SF32>
__global__ void __launch_bounds__(ROW_THREADS, 2)
attention_train_cols(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ stats,
                     T* __restrict__ dk, T* __restrict__ dv, const int* __restrict__ seed,
                     int seed_per_row, uint32_t threshold, float keep_w, float keep_f32,
                     const RowArgs p) {
  constexpr int QS = ColSlab<T>::QS;
  constexpr bool COPY = ColSlab<T>::COPY;
  using Mma = WarpMma<T, 4>;  // one group of 32 queries at a time
  constexpr int DC = Mma::DC;
  constexpr int NC = COL_HD / DC;
  using Score = typename std::conditional<SF32, float, T>::type;  // the score dtype
  using Acc = float[NC][DC / 8][4];
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = tile_ld(p.hdp, sizeof(T));
  T* ks = reinterpret_cast<T*>(smem_raw);  // [COL_KT][ld] keys
  T* vs = ks + COL_KT * ld;                // [COL_KT][ld] values
  T* qs = vs + COL_KT * ld;                // [QS][ld] queries
  T* dos = qs + QS * ld;                   // [QS][ld] dO
  T* qsc = COPY ? dos + QS * ld : qs;      // [QS][ld] scaled queries (bf16)
  float* rst = reinterpret_cast<float*>(ks + ColSlab<T>::ROWS * ld);

  const int warp = threadIdx.x >> 5;
  const int h = blockIdx.x;
  const long long b = blockIdx.y;
  const int k0 = blockIdx.z * COL_KT;
  const int nk = min(COL_KT, p.seq - k0);
  const int kw = k0 + 16 * warp;      // the warp's first key
  const bool live = k0 < p.klimit;    // keys at or past kv_len get no gradient
  const bool active = kw < p.klimit;  // (block- and warp-uniform)
  const T* kwp = ks + 16 * warp * ld;
  const T* vwp = vs + 16 * warp * ld;
  const Dropout drop = make_dropout(seed, seed_per_row, b, threshold, keep_w, keep_f32);
  Loader<T, ROW_THREADS> loads{reinterpret_cast<uint64_t*>(rst + 4 * QS), 0u, ld, p.hd,
                               p.copy_bytes};

  const T* qb = q + b * p.sqb + h * p.sqh;
  const T* kb = k + b * p.skb + h * p.skh;
  const T* vb = v + b * p.svb + h * p.svh;
  const long long ob = b * p.sob + h * p.soh;  // this (batch, head) in dO / dK / dV
  const long long plane = (long long)gridDim.y * p.heads * p.seq;
  const float* st = stats + (b * p.heads + h) * p.seq;

  // the keys and values, once for every sweep
  if (threadIdx.x == 0) mbar_init(loads.bar);
  zero_cols<ROW_THREADS>(ks, ld, ColSlab<T>::ROWS, p.hd, p.hdp);
  if (nk < COL_KT) {
    zero_rows<ROW_THREADS>(ks, ld, nk, COL_KT, p.hdp);
    zero_rows<ROW_THREADS>(vs, ld, nk, COL_KT, p.hdp);
  }
  __syncthreads();
  if (live) {
    loads.issue(ks, kb + (long long)k0 * p.skt, p.skt, nk);
    loads.issue(vs, vb + (long long)k0 * p.svt, p.svt, nk);
  }

#pragma unroll 1
  for (int dh = 0; dh < p.hdp; dh += COL_HD) {
    Acc ak = {}, av = {};
    // under the causal mask, queries before the tile's first key see none of it
#pragma unroll 1
    for (int i0 = p.causal ? k0 : 0; live && i0 < p.seq; i0 += QS) {
      const int n = min(QS, p.seq - i0);
      __syncthreads();  // the previous slab consumed
      if (n < QS) {  // (the products read whole groups: zero weights meet zeros)
        zero_rows<ROW_THREADS>(qs, ld, n, QS, p.hdp);
        zero_rows<ROW_THREADS>(dos, ld, n, QS, p.hdp);
      }
      loads.issue(qs, qb + (long long)i0 * p.sqt, p.sqt, n);
      loads.issue(dos, dout + ob + (long long)i0 * p.sot, p.sot, n);
      if (threadIdx.x < QS) {
        const int i = i0 + threadIdx.x;
        const bool real = i < p.seq;
        const float l = real ? st[plane + i] : 1.f;
        rst[threadIdx.x] = real ? st[i] : 0.f;
        rst[QS + threadIdx.x] = l;
        rst[2 * QS + threadIdx.x] = __frcp_rn(l);
        rst[3 * QS + threadIdx.x] = real ? st[2 * plane + i] : 0.f;
      }
      // the keep mask while the slab loads
      const uint32_t keep = drop.threshold ? keep_mask_cols<QS>(drop, h, kw, i0, p) : ~0u;
      loads.wait();
      __syncthreads();
      if constexpr (COPY) {
        scale_rows<ROW_THREADS>(qsc, qs, ld, QS, p.hdp, p.scale_q);
        __syncthreads();
      }

#pragma unroll 1
      for (int gq = 0; gq < QS / 32; ++gq) {
        const int ig = i0 + 32 * gq;  // the group's first query
        if (!active || ig >= p.seq || (p.causal && ig + 31 < kw)) continue;
        const T* qg = qs + 32 * gq * ld;
        const T* dg = dos + 32 * gq * ld;
        float s[4][4] = {}, c[4][4] = {};
        // S^T = K (scale q)^T, rounded to the score dtype, then P
        if constexpr (sizeof(T) == 2 && !SF32)
          scores_fma<4>(s, 0, 1, kwp, qsc + 32 * gq * ld, ld, p.hdp);
        else if constexpr (sizeof(T) == 2)
          Mma::group(s, kwp, qsc + 32 * gq * ld, ld, p.hdp);
        else
          Mma::template group<true>(s, kwp, qg, ld, p.hdp, p.scale_q);
        const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = 32 * gq + 8 * jj + 2 * t + (e & 1);  // the query in the slab
            const float x = softmax_num<T>(score_round<T>(s[jj][e], SF32), rst[r], SF32);
            s[jj][e] = sees(p, i0 + r, kw + g + 8 * (e >> 1))
                           ? round_to<Score>(divide(x, rst[QS + r], rst[2 * QS + r]))
                           : 0.f;
          }
        // dP^T = V dO^T; then dS^T in c and the dropped weights in s
        Mma::group(c, vwp, dg, ld, p.hdp);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = 32 * gq + 8 * jj + 2 * t + (e & 1);
            const bool kept = keep >> (16 * gq + 4 * jj + e) & 1u;
            const float pij = s[jj][e];
            const float dp = kept ? __fmul_rn(c[jj][e], drop.scale_f32) : 0.f;
            c[jj][e] = round_to<T>(pij * (dp - rst[3 * QS + r]));
            float wd = round_to<T>(pij);
            if (drop.threshold) wd = kept ? round_to<T>(wd * drop.scale_w) : 0.f;
            s[jj][e] = wd;
          }
        // dV += W dO, dK += dS q (values of T: packing them to bf16 is exact)
        typename Mma::Weights w;
        Mma::pack(s, w);
        accumulate_group(av, s, w, dg, ld, dh, p.hdp);
        Mma::pack(c, w);
        accumulate_group(ak, c, w, qg, ld, dh, p.hdp);
      }
    }
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      const int dc = dh + n * DC;
      if (dc < p.hdp) {
#pragma unroll
        for (int m = 0; m < DC / 8; ++m)
#pragma unroll
          for (int e = 0; e < 4; ++e) ak[n][m][e] *= p.scale_f32;
        store_rows<T, DC>(ak[n], dk + ob, p.sot, kw, p.seq, dc, p.hd);
        store_rows<T, DC>(av[n], dv + ob, p.sot, kw, p.seq, dc, p.hd);
      }
    }
  }
}

// Keys a slab of the tensor-core row pass holds: the rows' keys rounded up
// to a whole group, or as many groups as fit beside the ROW_QT rows of q
// (or dO) within `budget` bytes, whichever is fewer. The largest slab, not
// an even split: most tiles then need one.
int row_key_slab(int keys, int row_bytes, size_t budget) {
  const int need = (keys + GROUP - 1) / GROUP * GROUP;
  const int most = max(GROUP, ((int)(budget / row_bytes) - ROW_QT) / GROUP * GROUP);
  return min(need, most);
}

template <typename T, int KC, bool SF32>
cudaError_t launch_rows(const void* q, const void* k, const void* v, const void* dout, void* dq,
                        float* stats, const int* seed, int seed_per_row, uint32_t threshold,
                        float keep_f32, int batch, RowArgs p, cudaStream_t stream) {
  const int row_bytes = tile_ld(p.hdp, sizeof(T)) * sizeof(T);
  p.kslab = row_key_slab(min(KC, p.klimit), row_bytes, TWO_BLOCKS);  // as the forward's f32
  const size_t smem = (size_t)(ROW_QT + p.kslab) * row_bytes + 16;
  auto kernel = attention_train_rows<T, KC, SF32>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.seq + ROW_QT - 1) / ROW_QT, p.heads, batch);
  kernel<<<grid, ROW_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<T*>(dq), stats, seed, seed_per_row, threshold,
      keep_f32, p);
  return cudaGetLastError();
}

// The stored-row route's block (stored_block): rows too long for 16 rows of
// P return cudaErrorInvalidValue (the limits are in the note at the top).
template <typename T, bool SF32>
cudaError_t launch_stored_rows(const void* q, const void* k, const void* v, const void* dout,
                               void* dq, float* stats, const int* seed, int seed_per_row,
                               uint32_t threshold, float keep_f32, int batch, RowArgs p,
                               cudaStream_t stream) {
  using Score = typename std::conditional<SF32, float, T>::type;
  int cap = 0;
  cudaError_t err = shared_memory_cap(&cap);
  if (err != cudaSuccess) return err;
  StoredBlock block;
  if (!stored_block(p.klimit, tile_ld(p.hdp, sizeof(T)) * sizeof(T), sizeof(Score), cap, block))
    return cudaErrorInvalidValue;  // rows too long for this design
  p.qt = block.qt;
  p.kslab = block.kslab;
  auto kernel = attention_train_rows_stored<T, SF32>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)block.smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.seq + block.qt - 1) / block.qt, p.heads, batch);
  kernel<<<grid, ROW_THREADS, block.smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<T*>(dq), stats, seed, seed_per_row, threshold,
      keep_f32, p);
  return cudaGetLastError();
}

// The row pass: rows of up to 64 or MAX_KC keys on tensor cores with P in
// registers (one chunk, as the forward's dispatch), longer ones with P in
// shared memory.
template <typename T, bool SF32>
cudaError_t dispatch_rows(const void* q, const void* k, const void* v, const void* dout,
                          void* dq, float* stats, const int* seed, int seed_per_row,
                          uint32_t threshold, float keep_f32, int batch, const RowArgs& p,
                          cudaStream_t stream) {
  if (p.klimit <= 64)
    return launch_rows<T, 64, SF32>(q, k, v, dout, dq, stats, seed, seed_per_row, threshold,
                                    keep_f32, batch, p, stream);
  if (p.klimit <= MAX_KC)
    return launch_rows<T, MAX_KC, SF32>(q, k, v, dout, dq, stats, seed, seed_per_row,
                                        threshold, keep_f32, batch, p, stream);
  return launch_stored_rows<T, SF32>(q, k, v, dout, dq, stats, seed, seed_per_row, threshold,
                                     keep_f32, batch, p, stream);
}

template <typename T, bool SF32>
cudaError_t launch_cols(const void* q, const void* k, const void* v, const void* dout,
                        const float* stats, void* dk, void* dv, const int* seed, int seed_per_row,
                        uint32_t threshold, float keep_w, float keep_f32, int batch,
                        const RowArgs& p, cudaStream_t stream) {
  const size_t smem = col_smem_bytes<T>(p.hdp);
  const int tiles = (p.seq + COL_KT - 1) / COL_KT;
  int cap = 0;
  cudaError_t err = shared_memory_cap(&cap);
  if (err != cudaSuccess) return err;
  if (smem > (size_t)cap || tiles > 65535) return cudaErrorInvalidValue;
  auto kernel = attention_train_cols<T, SF32>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.heads, batch, tiles);
  kernel<<<grid, ROW_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), stats, static_cast<T*>(dk), static_cast<T*>(dv), seed,
      seed_per_row, threshold, keep_w, keep_f32, p);
  return cudaGetLastError();
}

template <typename T, bool SF32>
cudaError_t backward(const void* q, const void* k, const void* v, const void* dout, void* dq,
                     void* dk, void* dv, float* stats, const int* seed, int seed_per_row,
                     uint32_t threshold, float keep_w, float keep_f32, int batch,
                     const RowArgs& p, cudaStream_t stream) {
  cudaError_t err = dispatch_rows<T, SF32>(q, k, v, dout, dq, stats, seed, seed_per_row,
                                           threshold, keep_f32, batch, p, stream);
  if (err != cudaSuccess) return err;
  return launch_cols<T, SF32>(q, k, v, dout, stats, dk, dv, seed, seed_per_row, threshold,
                              keep_w, keep_f32, batch, p, stream);
}

bool valid_shape(int batch, int seq, int heads, int hd) {
  return batch >= 1 && batch <= 65535 && seq >= 1 && heads >= 1 && heads <= 65535 && hd >= 1 &&
         hd <= MAX_HD;
}

// The widest copy the tensor-core row pass can take: 16, 8 or 4 bytes, or
// the element, whichever first divides the row of hd elements and every
// address and stride in `spans` (in bytes). The forward's wrapper picks its
// width the same way (ops/attention.py kernel_layout).
int copy_width(int hd, int elem, const long long (&spans)[11]) {
  for (int width = 16; width > elem; width /= 2) {
    bool fits = (hd * elem) % width == 0;
    for (long long x : spans) fits = fits && x % width == 0;
    if (fits) return width;
  }
  return elem;
}

// [B, T, D] inputs with heads as column slices (head stride hd) and a
// contiguous [B, T, D] output
RowArgs row_args(int elem, const void* q, const void* k, const void* v, const void* dout,
                 int seq, int heads, int hd, long long sqb, long long sqt, long long skb,
                 long long skt, long long svb, long long svt, float scale_q, float scale_f32,
                 int causal, int kv_len, int softmax_f32) {
  RowArgs p;
  p.seq = seq;
  p.heads = heads;
  p.hd = hd;
  p.sqb = sqb;
  p.sqh = hd;
  p.sqt = sqt;
  p.skb = skb;
  p.skh = hd;
  p.skt = skt;
  p.svb = svb;
  p.svh = hd;
  p.svt = svt;
  p.sot = (long long)heads * hd;
  p.sob = seq * p.sot;
  p.soh = hd;
  p.scale_q = scale_q;
  p.scale_f32 = scale_f32;
  p.causal = causal;
  p.klimit = (kv_len > 0 && kv_len < seq) ? kv_len : seq;
  p.softmax_f32 = softmax_f32;
  p.hdp = (hd + 15) / 16 * 16;
  const long long spans[11] = {
      (long long)reinterpret_cast<uintptr_t>(q), (long long)reinterpret_cast<uintptr_t>(k),
      (long long)reinterpret_cast<uintptr_t>(v), (long long)reinterpret_cast<uintptr_t>(dout),
      sqb * elem, sqt * elem, skb * elem, skt * elem, svb * elem, svt * elem, p.sot * elem};
  p.copy_bytes = copy_width(hd, elem, spans);
  p.kslab = p.qt = 0;  // set by the launch
  return p;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; the last
// dimension of q, k, v is contiguous; dout, dq, dk, dv are contiguous
// [B, T, D] in the dtype. stats is f32 scratch of 3 * B * H * T. seed:
// int32, [B, 2] when seed_per_row, else [2]. threshold: drop iff bits <
// threshold (0 keeps everything). keep_w: 1/(1-rate) rounded to the dtype;
// keep_f32: 1/(1-rate) in f32. scale_q: 1/sqrt(hd) rounded to the dtype;
// scale_f32: 1/sqrt(hd) in f32. kv_len <= 0 means no key-length mask.
// Returns a cudaError_t.
int attention_train_backward(int dtype, const void* q, const void* k, const void* v,
                             const void* dout, void* dq, void* dk, void* dv, float* stats,
                             const int* seed, int seed_per_row, unsigned int threshold,
                             float keep_w, float keep_f32, int batch, int seq, int heads, int hd,
                             long long sqb, long long sqt, long long skb, long long skt,
                             long long svb, long long svt, float scale_q, float scale_f32,
                             int causal, int kv_len, int softmax_f32, void* stream) {
  if (!valid_shape(batch, seq, heads, hd) || dtype < 0 || dtype > 1)
    return cudaErrorInvalidValue;
  const RowArgs p = row_args(dtype == 0 ? 4 : 2, q, k, v, dout, seq, heads, hd, sqb, sqt, skb,
                             skt, svb, svt, scale_q, scale_f32, causal, kv_len, softmax_f32);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // an f32 softmax is the f32 inputs' own: one instantiation serves both
  if (dtype == 0)
    return backward<float, true>(q, k, v, dout, dq, dk, dv, stats, seed, seed_per_row,
                                 threshold, keep_w, keep_f32, batch, p, s);
  if (softmax_f32)
    return backward<__nv_bfloat16, true>(q, k, v, dout, dq, dk, dv, stats, seed, seed_per_row,
                                         threshold, keep_w, keep_f32, batch, p, s);
  return backward<__nv_bfloat16, false>(q, k, v, dout, dq, dk, dv, stats, seed, seed_per_row,
                                        threshold, keep_w, keep_f32, batch, p, s);
}

const char* attention_train_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
