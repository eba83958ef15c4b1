// The backward of multi-head attention on [B, T, D] activations with
// attention-weight dropout, for NVIDIA Hopper (sm_90a): the training
// attention's gradient only. Its forward (with dropout), the sampling
// attention and the [B, H, T, hd] attention run the tensor-core forward of
// attention_fwd.cu.
//
// Replaces the backward of the TPU kernel fused_attention_btd_train
// (custom_vjp _attn_train, body _train_bwd_kernel, math in _softmax_chunk
// and _apply_dropout) in regennet_tpu/ops/pallas_attention.py, and computes
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
// GFLOP (55 us at 67 TF/s f32): operations.
//
// Design (a first, simple one; CUDA-core FMAs from f32 copies in shared
// memory, no tensor cores yet), in two deterministic passes, no atomics:
//   1. row pass, one block per (query tile, head, batch): recomputes the
//      tile's score rows (f32 sums, rounded to the score dtype), computes
//      dO V^T rows, writes dQ, and writes each row's softmax max and sum
//      (score dtype) and D_i = sum_j dP_ij P_ij (f32) to a [3, B, H, T]
//      buffer;
//   2. column pass, one block per (key tile, head, batch): walks the query
//      tiles that can see its keys (from the tile's first key on under the
//      causal mask), recomputes P from the row statistics with the same
//      rounding points, and accumulates dK and dV in registers.
// q, k and v may be strided views (columns of one packed [B, T, 3D]
// projection): only the last dimension must be contiguous. dO, dQ, dK and
// dV take the strides in RowArgs.so*.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "attention_math.cuh"

namespace {

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

constexpr int THREADS = 256;
constexpr int KT = 64;       // key tile of the row pass
constexpr int CK = 32;       // keys per block in the column pass
constexpr int CQ = 32;       // query tile of the column pass
constexpr int MAX_HD = 256;  // largest head dim a launch takes

struct RowArgs {
  int seq, heads, hd;
  // strides in elements of q, k, v (batch, head, row) and of the output,
  // which dO, dQ, dK and dV share
  long long sqb, sqh, sqt, skb, skh, skt, svb, svh, svt, sob, soh, sot;
  float scale_q;    // scales q before QK, rounded to the input dtype
  float scale_f32;  // 1/sqrt(hd) in f32 (scales dQ and dK)
  int causal, klimit, softmax_f32;
};

// out[r * ostride + j] = sum_d a[r * ld + d] * M[j][d] for the QT rows of a
// and keys j < kmax, M streamed through `tile` in KT-row tiles; round = 1
// rounds each sum to the score dtype.
// The column pass sums over d in the same order, so it recomputes the
// rounded scores bit for bit.
template <typename T, int QT>
__device__ void row_products(const float* a, float* tile, const T* m, long long smt, int hd,
                             int ld, int kmax, float* out, int ostride, bool round,
                             int softmax_f32) {
  constexpr int RG = THREADS / KT;
  constexpr int RPT = QT / RG;
  const int tid = threadIdx.x;
  const int kj = tid % KT;
  const int rg = tid / KT;
  for (int k0 = 0; k0 < kmax; k0 += KT) {
    const int nk = min(KT, kmax - k0);
    __syncthreads();  // `a` written / previous tile consumed
    for (int i = tid; i < KT * hd; i += THREADS) {
      const int r = i / hd, d = i - r * hd;
      tile[r * ld + d] = r < nk ? to_f32<T>(m[(k0 + r) * smt + d]) : 0.f;
    }
    __syncthreads();
    float acc[RPT];
#pragma unroll
    for (int x = 0; x < RPT; ++x) acc[x] = 0.f;
    const float* mrow = tile + kj * ld;
    for (int d = 0; d < hd; ++d) {
      const float md = mrow[d];
#pragma unroll
      for (int x = 0; x < RPT; ++x) acc[x] = fmaf(a[(rg + x * RG) * ld + d], md, acc[x]);
    }
    if (kj < nk) {
#pragma unroll
      for (int x = 0; x < RPT; ++x)
        out[(rg + x * RG) * ostride + k0 + kj] =
            round ? score_round<T>(acc[x], softmax_f32) : acc[x];
    }
  }
}

// o[r][d] = sum_j w[r * wstride + j] * M[j][d] over keys j < kmax, M
// streamed through `tile`; returns per-thread accumulators in o (ACC of
// them, output e = tid + a * THREADS of the QT x hd tile).
template <typename T, int QT, int ACC>
__device__ void row_weighted_sum(const float* w, int wstride, float* tile, const T* m,
                                 long long smt, int hd, int ld, int kmax, float (&o)[ACC]) {
  const int tid = threadIdx.x;
  const int nout = QT * hd;
#pragma unroll
  for (int a = 0; a < ACC; ++a) o[a] = 0.f;
  for (int k0 = 0; k0 < kmax; k0 += KT) {
    const int nk = min(KT, kmax - k0);
    __syncthreads();  // weights written / previous tile consumed
    for (int i = tid; i < KT * hd; i += THREADS) {
      const int r = i / hd, d = i - r * hd;
      tile[r * ld + d] = r < nk ? to_f32<T>(m[(k0 + r) * smt + d]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int a = 0; a < ACC; ++a) {
      const int e = tid + a * THREADS;
      if (e < nout) {
        const int r = e / hd, d = e - r * hd;
        const float* wr = w + r * wstride + k0;
        const float* mc = tile + d;
        float acc = o[a];
        for (int j = 0; j < nk; ++j) acc = fmaf(wr[j], mc[j * ld], acc);
        o[a] = acc;
      }
    }
  }
}

template <int QT>
size_t row_smem_bytes(int hd, int klimit) {
  const size_t rows = (size_t)(2 * QT + KT) * (hd + 1);
  return sizeof(float) * (rows + (size_t)2 * QT * klimit);
}

// Backward row pass: reads dO and writes dQ (both in the output strides)
// and stats [3, B, H, T] (row max, row sum, D_i).
// grid: (ceil(seq / QT), heads, batch); THREADS threads.
template <typename T, int QT>
__global__ void __launch_bounds__(THREADS)
attention_train_rows(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, T* __restrict__ dq, float* __restrict__ stats,
                     const int* __restrict__ seed, int seed_per_row, uint32_t threshold,
                     float keep_f32, RowArgs p) {
  constexpr int ACC = (QT * MAX_HD + THREADS - 1) / THREADS;
  extern __shared__ float smem[];
  const int hd = p.hd, seq = p.seq, klimit = p.klimit;
  const int ld = hd + 1;
  float* qs = smem;               // [QT][ld] scaled queries
  float* tile = qs + QT * ld;     // [KT][ld] key / value tile
  float* sc = tile + KT * ld;     // [QT][klimit] scores, then P
  float* dos = sc + QT * klimit;  // [QT][ld] dO rows
  float* dps = dos + QT * ld;     // [QT][klimit] dO V^T, then dS

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * QT;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int rows = min(QT, seq - q0);
  const int kmax = p.causal ? min(klimit, q0 + rows) : klimit;
  const Dropout drop = make_dropout(seed, seed_per_row, b, threshold, 1.f, keep_f32);

  const T* qb = q + b * p.sqb + h * p.sqh;
  const T* kb = k + b * p.skb + h * p.skh;
  const T* vb = v + b * p.svb + h * p.svh;
  const long long ob = b * p.sob + h * p.soh;  // this (batch, head) in dO / dQ

  for (int i = tid; i < QT * hd; i += THREADS) {
    const int r = i / hd, d = i - r * hd;
    qs[r * ld + d] = r < rows ? round_to<T>(to_f32<T>(qb[(q0 + r) * p.sqt + d]) * p.scale_q) : 0.f;
    dos[r * ld + d] = r < rows ? to_f32<T>(dout[ob + (q0 + r) * p.sot + d]) : 0.f;
  }

  // scores, scaled and rounded to the score dtype; dO V^T rows in f32
  row_products<T, QT>(qs, tile, kb, p.skt, hd, ld, kmax, sc, klimit, true, p.softmax_f32);
  row_products<T, QT>(dos, tile, vb, p.svt, hd, ld, kmax, dps, klimit, false, 0);
  __syncthreads();

  // softmax of each real row over its valid keys, then dS, one warp a row
  const int warp = tid / 32, lane = tid % 32;
  for (int r = warp; r < rows; r += THREADS / 32) {
    const int i = q0 + r;
    float* srow = sc + r * klimit;
    const int n = p.causal ? min(klimit, i + 1) : klimit;
    float m = -CUDART_INF_F;
    for (int j = lane; j < n; j += 32) m = fmaxf(m, srow[j]);
    m = warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float e = softmax_num<T>(srow[j], m, p.softmax_f32);
      srow[j] = e;
      sum += e;
    }
    sum = score_round<T>(warp_sum(sum), p.softmax_f32);
    float* drow = dps + r * klimit;
    float dsum = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float pij = score_round<T>(srow[j] / sum, p.softmax_f32);
      const float dp = drop.keep(h, i, j) ? drow[j] * drop.scale_f32 : 0.f;
      srow[j] = pij;
      drow[j] = dp;
      dsum += dp * pij;
    }
    dsum = warp_sum(dsum);
    for (int j = lane; j < kmax; j += 32)
      drow[j] = j < n ? round_to<T>(srow[j] * (drow[j] - dsum)) : 0.f;
    if (lane == 0) {
      const long long plane = (long long)gridDim.z * p.heads * seq;
      const long long at = (b * p.heads + h) * seq + i;
      stats[at] = m;
      stats[plane + at] = sum;
      stats[2 * plane + at] = dsum;
    }
  }

  // dQ = scale * dS K
  float o[ACC];
  row_weighted_sum<T, QT, ACC>(dps, klimit, tile, kb, p.skt, hd, ld, kmax, o);

  const int nout = QT * hd;
#pragma unroll
  for (int a = 0; a < ACC; ++a) {
    const int e = tid + a * THREADS;
    if (e < nout) {
      const int r = e / hd, d = e - r * hd;
      if (r < rows) dq[ob + (q0 + r) * p.sot + d] = from_f32<T>(o[a] * p.scale_f32);
    }
  }
}

size_t col_smem_bytes(int hd) {
  return sizeof(float) * ((size_t)(2 * CK + 3 * CQ) * (hd + 1) + 2 * CQ * CK + 3 * CQ);
}

// Backward column pass: dK and dV of one key tile.
// grid: (ceil(seq / CK), heads, batch); THREADS threads.
template <typename T>
__global__ void __launch_bounds__(THREADS)
attention_train_cols(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ stats,
                     T* __restrict__ dk, T* __restrict__ dv, const int* __restrict__ seed,
                     int seed_per_row, uint32_t threshold, float keep_w, float keep_f32,
                     RowArgs p) {
  constexpr int ACC = (CK * MAX_HD + THREADS - 1) / THREADS;
  constexpr int RG = THREADS / CK;  // row groups in the score phase
  constexpr int RPT = CQ / RG;      // query rows per thread
  extern __shared__ float smem[];
  const int hd = p.hd, seq = p.seq, klimit = p.klimit;
  const int ld = hd + 1;
  float* ks = smem;            // [CK][ld] keys
  float* vs = ks + CK * ld;    // [CK][ld] values
  float* qu = vs + CK * ld;    // [CQ][ld] unscaled queries
  float* qsc = qu + CQ * ld;   // [CQ][ld] scaled queries
  float* dos = qsc + CQ * ld;  // [CQ][ld] dO rows
  float* wds = dos + CQ * ld;  // [CQ][CK] dropped weights
  float* dss = wds + CQ * CK;  // [CQ][CK] dS
  float* rst = dss + CQ * CK;  // [3][CQ] row max, row sum, D_i

  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * CK;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int nk = min(CK, seq - k0);
  const long long ob = b * p.sob + h * p.soh;  // this (batch, head) in dO / dK / dV
  const int nout = CK * hd;
  const Dropout drop = make_dropout(seed, seed_per_row, b, threshold, keep_w, keep_f32);

  float acc_k[ACC], acc_v[ACC];
#pragma unroll
  for (int a = 0; a < ACC; ++a) acc_k[a] = acc_v[a] = 0.f;

  if (k0 < klimit) {  // keys at or past kv_len get no gradient
    const T* qb = q + b * p.sqb + h * p.sqh;
    const T* kb = k + b * p.skb + h * p.skh;
    const T* vb = v + b * p.svb + h * p.svh;
    for (int i = tid; i < CK * hd; i += THREADS) {
      const int r = i / hd, d = i - r * hd;
      ks[r * ld + d] = r < nk ? to_f32<T>(kb[(k0 + r) * p.skt + d]) : 0.f;
      vs[r * ld + d] = r < nk ? to_f32<T>(vb[(k0 + r) * p.svt + d]) : 0.f;
    }
    const long long plane = (long long)gridDim.z * p.heads * seq;
    const float* st = stats + (b * p.heads + h) * seq;
    const int c = tid % CK;
    const int rg = tid / CK;
    const int j = k0 + c;
    // under the causal mask, queries before the tile's first key see none of it
    for (int i0 = p.causal ? k0 : 0; i0 < seq; i0 += CQ) {
      const int nq = min(CQ, seq - i0);
      __syncthreads();  // previous query tile consumed
      for (int i = tid; i < CQ * hd; i += THREADS) {
        const int r = i / hd, d = i - r * hd;
        const float x = r < nq ? to_f32<T>(qb[(i0 + r) * p.sqt + d]) : 0.f;
        qu[r * ld + d] = x;
        qsc[r * ld + d] = round_to<T>(x * p.scale_q);
        dos[r * ld + d] = r < nq ? to_f32<T>(dout[ob + (i0 + r) * p.sot + d]) : 0.f;
      }
      if (tid < CQ) {
        const bool real = tid < nq;
        rst[tid] = real ? st[i0 + tid] : 0.f;
        rst[CQ + tid] = real ? st[plane + i0 + tid] : 1.f;
        rst[2 * CQ + tid] = real ? st[2 * plane + i0 + tid] : 0.f;
      }
      __syncthreads();
      // scores and dO V^T of this (query, key) block, summed over d in the
      // row pass's order, so P is recomputed bit for bit
      float s_acc[RPT], p_acc[RPT];
#pragma unroll
      for (int x = 0; x < RPT; ++x) s_acc[x] = p_acc[x] = 0.f;
      const float* krow = ks + c * ld;
      const float* vrow = vs + c * ld;
      for (int d = 0; d < hd; ++d) {
        const float kd = krow[d], vd = vrow[d];
#pragma unroll
        for (int x = 0; x < RPT; ++x) {
          const int r = rg + x * RG;
          s_acc[x] = fmaf(qsc[r * ld + d], kd, s_acc[x]);
          p_acc[x] = fmaf(dos[r * ld + d], vd, p_acc[x]);
        }
      }
#pragma unroll
      for (int x = 0; x < RPT; ++x) {
        const int r = rg + x * RG;
        const int i = i0 + r;
        float wd = 0.f, ds = 0.f;
        if (r < nq && c < nk && j < klimit && (!p.causal || j <= i)) {
          const float s = score_round<T>(s_acc[x], p.softmax_f32);
          const float e = softmax_num<T>(s, rst[r], p.softmax_f32);
          const float pij = score_round<T>(e / rst[CQ + r], p.softmax_f32);
          const bool kept = drop.keep(h, i, j);
          wd = round_to<T>(pij);
          if (drop.threshold) wd = kept ? round_to<T>(wd * drop.scale_w) : 0.f;
          const float dp = kept ? p_acc[x] * drop.scale_f32 : 0.f;
          ds = round_to<T>(pij * (dp - rst[2 * CQ + r]));
        }
        wds[r * CK + c] = wd;
        dss[r * CK + c] = ds;
      }
      __syncthreads();
      // dV += W^T dO, dK += dS^T Q over this query tile
#pragma unroll
      for (int a = 0; a < ACC; ++a) {
        const int e = tid + a * THREADS;
        if (e < nout) {
          const int cc = e / hd, d = e - cc * hd;
          float av = acc_v[a], ak = acc_k[a];
          for (int r = 0; r < nq; ++r) {
            av = fmaf(wds[r * CK + cc], dos[r * ld + d], av);
            ak = fmaf(dss[r * CK + cc], qu[r * ld + d], ak);
          }
          acc_v[a] = av;
          acc_k[a] = ak;
        }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < ACC; ++a) {
    const int e = tid + a * THREADS;
    if (e < nout) {
      const int cc = e / hd, d = e - cc * hd;
      if (cc < nk) {
        const long long at = ob + (k0 + cc) * p.sot + d;
        dv[at] = from_f32<T>(acc_v[a]);
        dk[at] = from_f32<T>(acc_k[a] * p.scale_f32);
      }
    }
  }
}

cudaError_t shared_memory_cap(int* cap) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(cap, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return err;
}

template <typename T, int QT>
cudaError_t launch_rows(const void* q, const void* k, const void* v, const void* dout, void* dq,
                        float* stats, const int* seed, int seed_per_row, uint32_t threshold,
                        float keep_f32, int batch, const RowArgs& p, cudaStream_t stream) {
  const size_t smem = row_smem_bytes<QT>(p.hd, p.klimit);
  auto kernel = attention_train_rows<T, QT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.seq + QT - 1) / QT, p.heads, batch);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<T*>(dq), stats, seed, seed_per_row, threshold,
      keep_f32, p);
  return cudaGetLastError();
}

// the row pass at the widest query tile whose score rows fit in shared memory
template <typename T>
cudaError_t dispatch_rows(const void* q, const void* k, const void* v, const void* dout,
                          void* dq, float* stats, const int* seed, int seed_per_row,
                          uint32_t threshold, float keep_f32, int batch, const RowArgs& p,
                          cudaStream_t stream) {
  int cap = 0;
  cudaError_t err = shared_memory_cap(&cap);
  if (err != cudaSuccess) return err;
  if (row_smem_bytes<16>(p.hd, p.klimit) <= (size_t)cap)
    return launch_rows<T, 16>(q, k, v, dout, dq, stats, seed, seed_per_row, threshold, keep_f32,
                              batch, p, stream);
  if (row_smem_bytes<4>(p.hd, p.klimit) <= (size_t)cap)
    return launch_rows<T, 4>(q, k, v, dout, dq, stats, seed, seed_per_row, threshold, keep_f32,
                             batch, p, stream);
  return cudaErrorInvalidValue;  // sequence too long for this design
}

template <typename T>
cudaError_t backward(const void* q, const void* k, const void* v, const void* dout, void* dq,
                     void* dk, void* dv, float* stats, const int* seed, int seed_per_row,
                     uint32_t threshold, float keep_w, float keep_f32, int batch,
                     const RowArgs& p, cudaStream_t stream) {
  cudaError_t err = dispatch_rows<T>(q, k, v, dout, dq, stats, seed, seed_per_row, threshold,
                                     keep_f32, batch, p, stream);
  if (err != cudaSuccess) return err;
  int cap = 0;
  err = shared_memory_cap(&cap);
  if (err != cudaSuccess) return err;
  const size_t smem = col_smem_bytes(p.hd);
  if (smem > (size_t)cap) return cudaErrorInvalidValue;
  auto kernel = attention_train_cols<T>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.seq + CK - 1) / CK, p.heads, batch);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), stats, static_cast<T*>(dk), static_cast<T*>(dv), seed,
      seed_per_row, threshold, keep_w, keep_f32, p);
  return cudaGetLastError();
}

bool valid_shape(int batch, int seq, int heads, int hd) {
  return batch >= 1 && batch <= 65535 && seq >= 1 && heads >= 1 && heads <= 65535 && hd >= 1 &&
         hd <= MAX_HD;
}

// [B, T, D] inputs with heads as column slices (head stride hd) and a
// contiguous [B, T, D] output
RowArgs row_args(int seq, int heads, int hd, long long sqb, long long sqt, long long skb,
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
  if (!valid_shape(batch, seq, heads, hd)) return cudaErrorInvalidValue;
  const RowArgs p = row_args(seq, heads, hd, sqb, sqt, skb, skt, svb, svt, scale_q, scale_f32,
                             causal, kv_len, softmax_f32);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return backward<float>(q, k, v, dout, dq, dk, dv, stats, seed, seed_per_row, threshold,
                           keep_w, keep_f32, batch, p, s);
  if (dtype == 1)
    return backward<__nv_bfloat16>(q, k, v, dout, dq, dk, dv, stats, seed, seed_per_row,
                                   threshold, keep_w, keep_f32, batch, p, s);
  return cudaErrorInvalidValue;
}

const char* attention_train_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
