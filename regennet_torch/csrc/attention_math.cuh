// Rounding helpers that the attention kernels share, so that the forward
// kernel (attention_fwd.cu) and the training kernels (attention_btd_train.cu)
// round at the same points as their plain versions in ops/attention.py.
#pragma once

#include <cuda_bf16.h>

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

}  // namespace
