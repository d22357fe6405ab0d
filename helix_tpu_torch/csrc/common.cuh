// Shared helpers for the port's attention kernels: type conversion, the
// fp32 online-softmax steps of K2's float32 form, and the launch-resource
// query both kernels' info entry points answer with.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace helix {

constexpr float kLog2e = 1.4426950408889634f;

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

// Resources of one kernel at one launch shape: out[0] dynamic shared
// memory per block (bytes), out[1] registers per thread, out[2] blocks
// that fit on one SM, out[3] local-memory (spill) bytes per thread.
template <typename K>
cudaError_t kernel_info(K kern, int threads, size_t smem, int* out) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kern);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern, threads,
                                                      smem);
  out[0] = (int)smem;
  out[1] = attr.numRegs;
  out[2] = blocks;
  out[3] = (int)attr.localSizeBytes;
  return err;
}

}  // namespace helix
