// Shared helpers for the port's attention kernels: type conversion and
// the fp32 online-softmax steps both kernels run over shared memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace helix {

// -0.7 * FLT_MAX, the reference's DEFAULT_MASK_VALUE: exp(mask - m) is
// exactly 0 once a row has seen one live score.
constexpr float kMaskValue = -0.7f * 3.402823466e+38f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(int8_t x) {
  return static_cast<float>(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Online-softmax update for `rows` query rows against `n` staged keys
// whose masked scores sit in s[rows][ld]: folds the chunk's max into m,
// turns s into probabilities, rescales l and records each row's alpha.
__device__ __forceinline__ void softmax_rows(float* s, int ld, float* m,
                                             float* l, float* alpha,
                                             int rows, int n) {
  for (int i = threadIdx.x; i < rows; i += blockDim.x) {
    float* si = s + i * ld;
    float m_prev = m[i];
    float mx = m_prev;
    for (int j = 0; j < n; ++j) mx = fmaxf(mx, si[j]);
    float sum = 0.f;
    for (int j = 0; j < n; ++j) {
      float p = expf(si[j] - mx);
      si[j] = p;
      sum += p;
    }
    float a = expf(m_prev - mx);   // 0 while m_prev is -inf
    alpha[i] = a;
    l[i] = a * l[i] + sum;
    m[i] = mx;
  }
}

// acc[rows][D] = acc * alpha + P @ V over the n staged values v[n][D].
template <int D>
__device__ __forceinline__ void accumulate_pv(float* acc, const float* p,
                                              int ld, const float* alpha,
                                              const float* v, int rows,
                                              int n) {
  for (int e = threadIdx.x; e < rows * D; e += blockDim.x) {
    const int i = e / D, d = e % D;
    const float* pi = p + i * ld;
    float a = acc[e] * alpha[i];
    for (int j = 0; j < n; ++j) a += pi[j] * v[j * D + d];
    acc[e] = a;
  }
}

}  // namespace helix
