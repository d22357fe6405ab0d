// K2: causal flash attention with positions and packed segments, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel helix_tpu/ops/attention.py
// (flash_attention, body _flash_kernel).  q[B, Sq, H, D] attends
// k/v[B, Skv, KVH, D] (GQA: head h reads KV head h / (H / KVH)) where
// qpos >= kpos (when causal) and, when segment ids are given,
// qseg == kseg.  An optional tanh soft cap applies before masking; masked
// logits are the reference's DEFAULT_MASK_VALUE; fp32 online softmax; a
// row whose sum stays 0 writes 0.
//
// What bounds it on the H100: operations.  At prefill lengths every K/V
// tile is reused by 64 queries, so the work (4 * H * D FLOPs per live
// (query, key) pair) outgrows the bytes (q, k, v, o read or written once)
// well past the ~295 FLOP/byte ridge; the bound is the tensor cores'
// 989 TFLOP/s bf16.
//
// This first design is simple and right, not fast: one thread block per
// (q tile of 64, head h, batch b) loops over KV tiles of 32 staged in
// shared memory and scores with plain fp32 FMA loops -- no tensor cores,
// so it runs far from that bound.  It keeps the two things that matter
// for the work done: causal tile skipping computed from the positions
// (skip a KV tile when max(qpos of the tile) < min(kpos of the tile),
// the reference's position-based skip) and no [S, S] score matrix in
// device memory.  mma/wgmma tiles, TMA and warp specialisation are the
// later work.  Sequence lengths need not be multiples of the tiles: the
// ragged edge is masked and out-of-range K/V stage as 0.

#include "common.cuh"

namespace helix {
namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;
constexpr int kBK = 32;

template <int D>
__host__ __device__ constexpr size_t flash_smem_bytes() {
  // floats: q[BQ][D+1] acc[BQ][D] k[BK][D+1] v[BK][D] s[BQ][BK] m,l,a[BQ]
  // ints:   qpos,qseg[BQ] kpos,kseg[BK] + 2 reduction slots
  return ((size_t)kBQ * (2 * D + 1 + kBK + 3) + (size_t)kBK * (2 * D + 1)) *
             sizeof(float) +
         (size_t)(2 * kBQ + 2 * kBK + 2) * sizeof(int);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const int* __restrict__ qpos,
             const int* __restrict__ kpos, const int* __restrict__ qseg,
             const int* __restrict__ kseg, T* __restrict__ out, int Sq,
             int Skv, int H, int KVH, int causal, float scale,
             float soft_cap) {
  constexpr int DP = D + 1;
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * kBQ;
  const int rows = min(kBQ, Sq - q0);
  const int kvh = h / (H / KVH);
  const bool use_seg = qseg != nullptr;

  extern __shared__ float smem[];
  float* q_s = smem;
  float* acc_s = q_s + kBQ * DP;
  float* k_s = acc_s + kBQ * D;
  float* v_s = k_s + kBK * DP;
  float* s_s = v_s + kBK * D;
  float* m_s = s_s + kBQ * kBK;
  float* l_s = m_s + kBQ;
  float* a_s = l_s + kBQ;
  int* qpos_s = reinterpret_cast<int*>(a_s + kBQ);
  int* qseg_s = qpos_s + kBQ;
  int* kpos_s = qseg_s + kBQ;
  int* kseg_s = kpos_s + kBK;
  int* red_s = kseg_s + kBK;   // [0] = max qpos of the tile, [1] = min kpos

  for (int e = threadIdx.x; e < rows * D; e += blockDim.x) {
    const int i = e / D, d = e % D;
    q_s[i * DP + d] =
        to_float(q[(((size_t)b * Sq + q0 + i) * H + h) * D + d]);
    acc_s[e] = 0.f;
  }
  for (int i = threadIdx.x; i < rows; i += blockDim.x) {
    m_s[i] = -INFINITY;
    l_s[i] = 0.f;
    qpos_s[i] = qpos[(size_t)b * Sq + q0 + i];
    qseg_s[i] = use_seg ? qseg[(size_t)b * Sq + q0 + i] : 0;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int mx = qpos_s[0];
    for (int i = 1; i < rows; ++i) mx = max(mx, qpos_s[i]);
    red_s[0] = mx;
  }

  for (int k0 = 0; k0 < Skv; k0 += kBK) {
    const int n = min(kBK, Skv - k0);
    __syncthreads();   // previous tile consumed, red_s[0] visible
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      kpos_s[j] = kpos[(size_t)b * Skv + k0 + j];
      kseg_s[j] = use_seg ? kseg[(size_t)b * Skv + k0 + j] : 0;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      int mn = kpos_s[0];
      for (int j = 1; j < n; ++j) mn = min(mn, kpos_s[j]);
      red_s[1] = mn;
    }
    __syncthreads();
    // causal tile skipping: every key of the tile lies past every query
    if (causal && red_s[0] < red_s[1]) continue;
    for (int e = threadIdx.x; e < kBK * D; e += blockDim.x) {
      const int j = e / D, d = e % D;
      float kv = 0.f, vv = 0.f;
      if (j < n) {
        const size_t off = (((size_t)b * Skv + k0 + j) * KVH + kvh) * D + d;
        kv = to_float(k[off]);
        vv = to_float(v[off]);
      }
      k_s[j * DP + d] = kv;
      v_s[j * D + d] = vv;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < rows * kBK; e += blockDim.x) {
      const int i = e / kBK, j = e % kBK;
      float s = kMaskValue;
      if (j < n) {
        float dot = 0.f;
        for (int d = 0; d < D; ++d) dot += q_s[i * DP + d] * k_s[j * DP + d];
        s = dot * scale;
        if (soft_cap > 0.f) s = soft_cap * tanhf(s / soft_cap);
        bool ok = true;
        if (causal) ok = qpos_s[i] >= kpos_s[j];
        if (use_seg) ok = ok && (qseg_s[i] == kseg_s[j]);
        if (!ok) s = kMaskValue;
      }
      s_s[e] = s;
    }
    __syncthreads();
    softmax_rows(s_s, kBK, m_s, l_s, a_s, rows, n);
    __syncthreads();
    accumulate_pv<D>(acc_s, s_s, kBK, a_s, v_s, rows, n);
  }
  __syncthreads();

  for (int e = threadIdx.x; e < rows * D; e += blockDim.x) {
    const int i = e / D, d = e % D;
    const float l = l_s[i];
    const float o = l == 0.f ? 0.f : acc_s[e] / l;
    out[(((size_t)b * Sq + q0 + i) * H + h) * D + d] = from_float<T>(o);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* qpos, const int* kpos, const int* qseg,
                   const int* kseg, void* out, int B, int Sq, int Skv, int H,
                   int KVH, int causal, float scale, float soft_cap,
                   cudaStream_t stream) {
  const size_t smem = flash_smem_bytes<D>();
  auto kern = flash_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), qpos, kpos, qseg, kseg,
      static_cast<T*>(out), Sq, Skv, H, KVH, causal, scale, soft_cap);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v,
                       const int* qpos, const int* kpos, const int* qseg,
                       const int* kseg, void* out, int B, int Sq, int Skv,
                       int H, int KVH, int causal, float scale,
                       float soft_cap, cudaStream_t s) {
#define HELIX_K2_CASE(DIM)                                                 \
  case DIM:                                                                \
    return launch<T, DIM>(q, k, v, qpos, kpos, qseg, kseg, out, B, Sq,    \
                          Skv, H, KVH, causal, scale, soft_cap, s);
  switch (D) {
    HELIX_K2_CASE(16)
    HELIX_K2_CASE(32)
    HELIX_K2_CASE(64)
    HELIX_K2_CASE(96)
    HELIX_K2_CASE(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef HELIX_K2_CASE
}

}  // namespace
}  // namespace helix

// dtype: 0 = float32, 1 = bfloat16.  q/out [B, Sq, H, D], k/v
// [B, Skv, KVH, D], qpos/qseg [B, Sq] and kpos/kseg [B, Skv] int32, all
// contiguous device memory; qseg/kseg may both be null (no segments).
// soft_cap <= 0 disables the cap.
extern "C" int helix_flash_attention(
    const void* q, const void* k, const void* v, const void* qpos,
    const void* kpos, const void* qseg, const void* kseg, void* out, int B,
    int Sq, int Skv, int H, int KVH, int D, int causal, float scale,
    float soft_cap, int dtype, void* stream) {
  using namespace helix;
  auto s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || Sq <= 0) return cudaSuccess;
  if (Skv <= 0 || H % KVH != 0) return cudaErrorInvalidValue;
  const auto* qp = static_cast<const int*>(qpos);
  const auto* kp = static_cast<const int*>(kpos);
  const auto* qs = static_cast<const int*>(qseg);
  const auto* ks = static_cast<const int*>(kseg);
  cudaError_t err;
  if (dtype == 0) {
    err = dispatch_d<float>(D, q, k, v, qp, kp, qs, ks, out, B, Sq, Skv, H,
                            KVH, causal, scale, soft_cap, s);
  } else if (dtype == 1) {
    err = dispatch_d<__nv_bfloat16>(D, q, k, v, qp, kp, qs, ks, out, B, Sq,
                                    Skv, H, KVH, causal, scale, soft_cap, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
