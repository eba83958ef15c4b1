// What the attention kernels share: the rounding helpers, so that the
// forward kernel (attention_fwd.cu) and the training backward
// (attention_btd_train.cu) round at the same points as their plain versions
// in ops/attention.py, and the one Philox draw of the dropout mask, so that
// the backward regenerates the forward's mask bit for bit.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

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

// score-dtype rounding: T unless the softmax runs in f32
template <typename T> __device__ __forceinline__ float score_round(float x, int softmax_f32) {
  return softmax_f32 ? x : round_to<T>(x);
}

// softmax numerator exp(s - m) with the score dtype's rounding points
template <typename T> __device__ __forceinline__ float softmax_num(float s, float m, int softmax_f32) {
  return softmax_f32 ? expf(s - m) : round_to<T>(expf(round_to<T>(s - m)));
}

// Dropout bits: Philox4x32-10 keyed by the batch row's two seed words (a
// replicated [2] seed adds row * 0x9E3779B9 to the first word), with counter
// (key j, query i, head h0 + h, 0); the first output word is the bits. h0
// is 0, or the third word of a [B, 3] seed: the global index of the first
// head under tensor parallelism, so that a rank's heads draw the bits of
// the same heads of the whole model. The mask depends on (seed, b, h, i,
// j) only: not on the grid, the tiles or which kernel asks, and the plain
// version (ops/attention.dropout_bits) computes the same bits.
constexpr uint32_t PHILOX_M0 = 0xD2511F53u, PHILOX_M1 = 0xCD9E8D57u;
constexpr uint32_t PHILOX_W0 = 0x9E3779B9u, PHILOX_W1 = 0xBB67AE85u;

// first output word of Philox4x32-10 for counter (c0, c1, c2, 0)
__device__ __forceinline__ uint32_t philox_word0(uint32_t k0, uint32_t k1, uint32_t c0,
                                                 uint32_t c1, uint32_t c2) {
  uint32_t c3 = 0u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t lo0 = PHILOX_M0 * c0, hi0 = __umulhi(PHILOX_M0, c0);
    const uint32_t lo1 = PHILOX_M1 * c2, hi1 = __umulhi(PHILOX_M1, c2);
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += PHILOX_W0;
    k1 += PHILOX_W1;
  }
  return c0;
}

struct Dropout {
  uint32_t k0, k1;     // Philox key of this batch row
  uint32_t h0;         // the global index of head 0
  uint32_t threshold;  // drop iff bits < threshold; 0 keeps every weight
  float scale_w;       // 1/(1-rate) in the weights' dtype
  float scale_f32;     // 1/(1-rate) in f32, for dP

  __device__ __forceinline__ uint32_t bits(int h, int i, int j) const {
    return philox_word0(k0, k1, (uint32_t)j, (uint32_t)i, h0 + (uint32_t)h);
  }
  __device__ __forceinline__ bool keep(int h, int i, int j) const {
    return threshold == 0u || bits(h, i, j) >= threshold;
  }
};

// seed_per_row: 0 for a [2] seed, 1 for [B, 2], 2 for [B, 3] (with h0)
__device__ __forceinline__ Dropout make_dropout(const int* seed, int seed_per_row, long long b,
                                                uint32_t threshold, float scale_w,
                                                float scale_f32) {
  Dropout d;
  d.h0 = 0u;
  if (threshold == 0u) {  // nothing is dropped; seed may be null
    d.k0 = d.k1 = 0u;
  } else if (seed_per_row) {
    const long long words = seed_per_row == 2 ? 3 : 2;
    d.k0 = (uint32_t)seed[words * b];
    d.k1 = (uint32_t)seed[words * b + 1];
    if (seed_per_row == 2) d.h0 = (uint32_t)seed[words * b + 2];
  } else {
    d.k0 = (uint32_t)seed[0] + (uint32_t)b * PHILOX_W0;
    d.k1 = (uint32_t)seed[1];
  }
  d.threshold = threshold;
  d.scale_w = scale_w;
  d.scale_f32 = scale_f32;
  return d;
}

}  // namespace
