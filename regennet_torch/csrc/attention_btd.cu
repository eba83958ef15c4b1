// Multi-head self-attention on [B, T, D] activations, heads as column
// slices of D, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel fused_attention_btd in
// regennet_tpu/ops/pallas_attention.py (body _attn_btd_kernel, math in
// attention_btd_chunks and _softmax_chunk) and computes what it computes:
//   * q is scaled by 1/sqrt(hd) in the input dtype before QK;
//   * scores accumulate in f32 and are rounded to the input dtype unless
//     softmax_f32 is set (the bf16 softmax of the sampling path);
//   * a causal mask (key <= query) and/or a key-length mask (key < kv_len);
//     masked scores are -1e30 there, whose weight is exactly 0, so masked
//     keys are skipped here;
//   * softmax as max, exp, sum, divide, each rounded to the softmax dtype;
//     the weights are cast to v's dtype and AV accumulates in f32;
//   * f32 or bf16 in, the same dtype out.
//
// What bounds it on an H100: bytes. q, k and v are read once and the
// output written once, 4*B*T*D*itemsize bytes (78.6 MB at bf16,
// B=128, T=150, D=512: 23 us at 3.35 TB/s), against ~3 GFLOP under the
// causal mask (3 us at the bf16 tensor-core rate).
//
// Design (a first, simple one): one block per (query tile, head, batch).
// The block stages the tile's scaled queries, then key tiles, then value
// tiles through shared memory as f32, and holds the whole score row of
// each of its queries in shared memory, so the softmax runs in two exact
// passes with the TPU kernel's rounding points (no online rescaling).
// Products run on CUDA cores (fmaf). Key tiles past the causal or kv_len
// limit of the query tile are never loaded. q, k and v may be strided
// views (e.g. column slices of one packed [B, T, 3D] projection): only the
// last dimension must be contiguous. Tensor cores (wgmma) and TMA are
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int THREADS = 256;
constexpr int KT = 64;       // keys per shared-memory tile
constexpr int MAX_HD = 256;  // largest head dim a launch takes

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even
}

// x rounded to T and widened back to f32
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32<T>(from_f32<T>(x));
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int QT>
size_t smem_bytes(int hd, int klimit) {
  return sizeof(float) * ((size_t)(QT + KT) * (hd + 1) + (size_t)QT * klimit);
}

// grid: (ceil(seq / QT), heads, batch); THREADS threads.
// klimit: keys a row may see at most (kv_len, or seq); causal rows see
// min(klimit, row + 1). softmax_f32 = 0 runs the softmax in T.
template <typename T, int QT>
__global__ void __launch_bounds__(THREADS)
attention_btd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out, int seq,
                     int heads, int hd, long long sqb, long long sqt,
                     long long skb, long long skt, long long svb,
                     long long svt, float scale, int causal, int klimit,
                     int softmax_f32) {
  constexpr int RG = THREADS / KT;  // row groups in the score phase
  static_assert(QT % RG == 0, "query tile must split over the row groups");
  constexpr int RPT = QT / RG;      // score rows per thread
  constexpr int ACC = (QT * MAX_HD + THREADS - 1) / THREADS;  // outputs per thread

  extern __shared__ float smem[];
  const int ld = hd + 1;  // padded rows: column reads hit distinct banks
  float* qs = smem;                 // [QT][ld] scaled queries
  float* kv = qs + QT * ld;         // [KT][ld] key tile, later value tile
  float* sc = kv + KT * ld;         // [QT][klimit] scores, then weights

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * QT;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int rows = min(QT, seq - q0);                          // real query rows
  const int kmax = causal ? min(klimit, q0 + rows) : klimit;  // keys the tile sees

  const T* qb = q + b * sqb + (long long)h * hd;
  const T* kb = k + b * skb + (long long)h * hd;
  const T* vb = v + b * svb + (long long)h * hd;

  // queries scaled in the input dtype, before QK
  for (int i = tid; i < QT * hd; i += THREADS) {
    const int r = i / hd, d = i - r * hd;
    qs[r * ld + d] = r < rows ? round_to<T>(to_f32<T>(qb[(q0 + r) * sqt + d]) * scale) : 0.f;
  }

  // phase 1: scores for keys [0, kmax), f32 accumulation
  const int kj = tid % KT;
  const int rg = tid / KT;
  for (int k0 = 0; k0 < kmax; k0 += KT) {
    const int nk = min(KT, kmax - k0);
    __syncthreads();  // queries written / previous tile consumed
    for (int i = tid; i < KT * hd; i += THREADS) {
      const int r = i / hd, d = i - r * hd;
      kv[r * ld + d] = r < nk ? to_f32<T>(kb[(k0 + r) * skt + d]) : 0.f;
    }
    __syncthreads();
    float acc[RPT];
#pragma unroll
    for (int a = 0; a < RPT; ++a) acc[a] = 0.f;
    const float* krow = kv + kj * ld;
    for (int d = 0; d < hd; ++d) {
      const float kd = krow[d];
#pragma unroll
      for (int a = 0; a < RPT; ++a) acc[a] = fmaf(qs[(rg + a * RG) * ld + d], kd, acc[a]);
    }
    if (kj < nk) {
#pragma unroll
      for (int a = 0; a < RPT; ++a) {
        const float s = acc[a];
        sc[(rg + a * RG) * klimit + k0 + kj] = softmax_f32 ? s : round_to<T>(s);
      }
    }
  }
  __syncthreads();

  // phase 2: softmax of each real row over its valid keys, one warp a row;
  // weights of masked keys in [valid, kmax) are 0
  const int warp = tid / 32, lane = tid % 32;
  for (int r = warp; r < rows; r += THREADS / 32) {
    float* srow = sc + r * klimit;
    const int n = causal ? min(klimit, q0 + r + 1) : klimit;
    float m = -CUDART_INF_F;
    for (int j = lane; j < n; j += 32) m = fmaxf(m, srow[j]);
    m = warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float p = softmax_f32 ? expf(srow[j] - m)
                                  : round_to<T>(expf(round_to<T>(srow[j] - m)));
      srow[j] = p;
      sum += p;
    }
    sum = warp_sum(sum);
    if (!softmax_f32) sum = round_to<T>(sum);
    for (int j = lane; j < kmax; j += 32) srow[j] = j < n ? round_to<T>(srow[j] / sum) : 0.f;
  }

  // phase 3: out = W V over value tiles, f32 accumulation
  float o[ACC];
#pragma unroll
  for (int a = 0; a < ACC; ++a) o[a] = 0.f;
  const int nout = QT * hd;
  for (int k0 = 0; k0 < kmax; k0 += KT) {
    const int nk = min(KT, kmax - k0);
    __syncthreads();  // weights written / previous tile consumed
    for (int i = tid; i < KT * hd; i += THREADS) {
      const int r = i / hd, d = i - r * hd;
      kv[r * ld + d] = r < nk ? to_f32<T>(vb[(k0 + r) * svt + d]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int a = 0; a < ACC; ++a) {
      const int e = tid + a * THREADS;
      if (e < nout) {
        const int r = e / hd, d = e - r * hd;
        const float* w = sc + r * klimit + k0;
        const float* vc = kv + d;
        float acc = o[a];
        for (int j = 0; j < nk; ++j) acc = fmaf(w[j], vc[j * ld], acc);
        o[a] = acc;
      }
    }
  }

  const long long dmodel = (long long)heads * hd;
#pragma unroll
  for (int a = 0; a < ACC; ++a) {
    const int e = tid + a * THREADS;
    if (e < nout) {
      const int r = e / hd, d = e - r * hd;
      if (r < rows) out[(b * seq + q0 + r) * dmodel + (long long)h * hd + d] = from_f32<T>(o[a]);
    }
  }
}

template <typename T, int QT>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int batch, int seq, int heads, int hd, long long sqb,
                   long long sqt, long long skb, long long skt, long long svb,
                   long long svt, float scale, int causal, int klimit,
                   int softmax_f32, cudaStream_t stream) {
  const size_t smem = smem_bytes<QT>(hd, klimit);
  auto kernel = attention_btd_kernel<T, QT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((seq + QT - 1) / QT, heads, batch);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), seq, heads, hd, sqb, sqt, skb, skt, svb, svt, scale,
      causal, klimit, softmax_f32);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* out,
                     int batch, int seq, int heads, int hd, long long sqb,
                     long long sqt, long long skb, long long skt, long long svb,
                     long long svt, float scale, int causal, int klimit,
                     int softmax_f32, cudaStream_t stream) {
  int device = 0, cap = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&cap, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  // the widest query tile whose score rows fit in shared memory
  if (smem_bytes<16>(hd, klimit) <= (size_t)cap)
    return launch<T, 16>(q, k, v, out, batch, seq, heads, hd, sqb, sqt, skb, skt,
                         svb, svt, scale, causal, klimit, softmax_f32, stream);
  if (smem_bytes<4>(hd, klimit) <= (size_t)cap)
    return launch<T, 4>(q, k, v, out, batch, seq, heads, hd, sqb, sqt, skb, skt,
                        svb, svt, scale, causal, klimit, softmax_f32, stream);
  return cudaErrorInvalidValue;  // sequence too long for this design
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; the last
// dimension is contiguous. scale is 1/sqrt(hd) already rounded to the
// dtype. kv_len <= 0 means no key-length mask. Returns a cudaError_t.
int attention_btd_launch(int dtype, const void* q, const void* k, const void* v,
                         void* out, int batch, int seq, int heads, int hd,
                         long long sqb, long long sqt, long long skb,
                         long long skt, long long svb, long long svt,
                         float scale, int causal, int kv_len, int softmax_f32,
                         void* stream) {
  if (batch < 1 || batch > 65535 || seq < 1 || heads < 1 || heads > 65535 ||
      hd < 1 || hd > MAX_HD)
    return cudaErrorInvalidValue;
  const int klimit = (kv_len > 0 && kv_len < seq) ? kv_len : seq;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, out, batch, seq, heads, hd, sqb, sqt, skb, skt,
                           svb, svt, scale, causal, klimit, softmax_f32, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, out, batch, seq, heads, hd, sqb, sqt,
                                   skb, skt, svb, svt, scale, causal, klimit,
                                   softmax_f32, s);
  return cudaErrorInvalidValue;
}

const char* attention_btd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
