// K1: ragged paged attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel helix_tpu/ops/paged_kernel.py
// (ragged_paged_attention_tpu, body _ragged_kernel).  Same contract as
// helix_tpu/ops/paged.py: a flat query axis q[T, H, D] carved into rows by
// t0/q_len; token t of row r sits at position hist[r] + (t - t0[r]) and
// attends the row's pages-resident history [0, hist[r]) of layer `layer`
// (read through tables[r]) plus the row's fresh k_new/v_new up to and
// including itself.  fp32 online softmax, scale given by the caller.
//
// What bounds it on the H100: bytes.  Decode reads every history token's
// K and V once per KV head (2 * hist * KVH * D elements per row) and does
// ~4 * group FLOPs per element read, far below the ~295 FLOP/byte where
// the tensor cores would become the limit.
//
// This first design is simple and right, not fast: one thread block per
// (q tile of up to 16 tokens, KV head g, row r) covers the H/KVH query
// heads of g, stages history in chunks of up to 32 tokens of K/V in shared
// memory (page by page through tables[r], only ceil(hist/P) pages, never
// maxP), and scores with plain FMA loops.  There is no split over pages,
// so decode runs rows * KVH blocks (64 at 8 rows x 8 heads on 132 SMs) and
// long histories are walked serially; a split-K pass, cp.async/TMA
// staging and mma/wgmma are the later work.
//
// Differences from the TPU kernel, kept deliberately:
//  * blocks run in parallel in no order, so stores are masked to the
//    row's own tokens [t0, t0 + q_len) -- there is no tail spill onto the
//    next row and no padded T;
//  * V (and K) outside the live range are staged as 0, so a masked slot
//    can never poison the sum through 0 * NaN (garbage pages, a
//    neighbouring row's NaN fresh V);
//  * the pool holds all L layers; only layer `layer` is read.
//
// Int8 pools (the Pallas kernel's quantized=True form, K1-int8): the pool
// holds int8 codes and two float32 scale pools [L, N, P, KVH], one scale
// per (token slot, KV head).  Each history element is staged as
// float(code) * scale in f32 -- never rounded to the query dtype, as the
// TPU kernel dequantizes in-register (paged_kernel.py:219-227) -- and
// only the ceil(hist/P) pages a row walks have their scales read.  Fresh
// K/V stay at the query dtype.  An int8 pool moves 2*D + 8 bytes per
// history token and KV head (264 B at D=128) where a bf16 pool moves
// 4*D (512 B); the design is otherwise the float kernel's.

#include <type_traits>

#include "common.cuh"

namespace helix {
namespace {

constexpr int kThreads = 256;
constexpr int kTileTokens = 16;   // query tokens per block
constexpr int kMaxChunk = 32;     // K/V tokens staged per step

template <int D>
__host__ __device__ constexpr size_t smem_floats(int group, int chunk) {
  // q[TT*G][D+1] acc[TT*G][D] k[C][D+1] v[C][D] s[TT*G][C] m,l,alpha[TT*G]
  return (size_t)kTileTokens * group * (2 * D + 1 + chunk + 3) +
         (size_t)chunk * (2 * D + 1);
}

// T: query / fresh K/V / output type; TP: pool element type (T, or
// int8_t with the scale pools k_scale/v_scale, nullptr otherwise).
template <typename T, typename TP, int D>
__global__ void __launch_bounds__(kThreads)
ragged_kernel(const T* __restrict__ q, const T* __restrict__ k_new,
              const T* __restrict__ v_new, const TP* __restrict__ k_pages,
              const TP* __restrict__ v_pages,
              const float* __restrict__ k_scale,
              const float* __restrict__ v_scale, const int* __restrict__ t0,
              const int* __restrict__ q_len, const int* __restrict__ hist,
              const int* __restrict__ tables, T* __restrict__ out, int H,
              int KVH, int N, int P, int maxP, int layer, int chunk,
              float scale) {
  constexpr bool kQuant = std::is_same<TP, int8_t>::value;
  constexpr int DP = D + 1;   // padded row: conflict-free column reads
  const int tile = blockIdx.x, g = blockIdx.y, r = blockIdx.z;
  const int ql = q_len[r];
  const int tok0 = tile * kTileTokens;
  if (tok0 >= ql) return;   // parked row or tile past the row's length
  const int group = H / KVH;
  const int ntok = min(kTileTokens, ql - tok0);
  const int rows = ntok * group;   // row i: token i / group, head i % group
  const int base = t0[r];
  const int hr = hist[r];

  extern __shared__ float smem[];
  const int cap = kTileTokens * group;
  float* q_s = smem;
  float* acc_s = q_s + cap * DP;
  float* k_s = acc_s + cap * D;
  float* v_s = k_s + chunk * DP;
  float* s_s = v_s + chunk * D;
  float* m_s = s_s + cap * chunk;
  float* l_s = m_s + cap;
  float* a_s = l_s + cap;

  for (int e = threadIdx.x; e < rows * D; e += blockDim.x) {
    const int i = e / D, d = e % D;
    const size_t src =
        ((size_t)(base + tok0 + i / group) * H + g * group + i % group) * D +
        d;
    q_s[i * DP + d] = to_float(q[src]);
    acc_s[e] = 0.f;
  }
  for (int i = threadIdx.x; i < rows; i += blockDim.x) {
    m_s[i] = -INFINITY;
    l_s[i] = 0.f;
  }

  const size_t slot_off = (size_t)layer * N * P * KVH;   // scale pools
  const TP* kp = k_pages + slot_off * D;
  const TP* vp = v_pages + slot_off * D;
  const int* table = tables + (size_t)r * maxP;

  // ---- history: walk only the pages the row uses ----------------------
  for (int c0 = 0; c0 < hr; c0 += chunk) {
    const int n = min(chunk, hr - c0);
    __syncthreads();   // previous chunk fully consumed
    for (int e = threadIdx.x; e < chunk * D; e += blockDim.x) {
      const int j = e / D, d = e % D;
      float kv = 0.f, vv = 0.f;
      if (j < n) {
        const int pos = c0 + j;
        int page = table[min(pos / P, maxP - 1)];
        page = min(max(page, 0), N - 1);
        const size_t slot = ((size_t)page * P + pos % P) * KVH + g;
        kv = to_float(kp[slot * D + d]);
        vv = to_float(vp[slot * D + d]);
        if constexpr (kQuant) {
          kv *= k_scale[slot_off + slot];
          vv *= v_scale[slot_off + slot];
        }
      }
      k_s[j * DP + d] = kv;
      v_s[j * D + d] = vv;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < rows * chunk; e += blockDim.x) {
      const int i = e / chunk, j = e % chunk;
      float s = kMaskValue;
      if (j < n) {   // every history token precedes every fresh token
        float dot = 0.f;
        for (int d = 0; d < D; ++d) dot += q_s[i * DP + d] * k_s[j * DP + d];
        s = dot * scale;
      }
      s_s[e] = s;
    }
    __syncthreads();
    softmax_rows(s_s, chunk, m_s, l_s, a_s, rows, n);
    __syncthreads();
    accumulate_pv<D>(acc_s, s_s, chunk, a_s, v_s, rows, n);
  }

  // ---- fresh tokens of this row, causal --------------------------------
  const int fresh_end = min(ql, tok0 + ntok);   // last query's limit
  for (int f0 = 0; f0 < fresh_end; f0 += chunk) {
    const int n = min(chunk, ql - f0);
    __syncthreads();
    for (int e = threadIdx.x; e < chunk * D; e += blockDim.x) {
      const int j = e / D, d = e % D;
      float kv = 0.f, vv = 0.f;
      if (j < n) {
        const size_t off = ((size_t)(base + f0 + j) * KVH + g) * D + d;
        kv = to_float(k_new[off]);
        vv = to_float(v_new[off]);
      }
      k_s[j * DP + d] = kv;
      v_s[j * D + d] = vv;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < rows * chunk; e += blockDim.x) {
      const int i = e / chunk, j = e % chunk;
      float s = kMaskValue;
      if (j < n && f0 + j <= tok0 + i / group) {
        float dot = 0.f;
        for (int d = 0; d < D; ++d) dot += q_s[i * DP + d] * k_s[j * DP + d];
        s = dot * scale;
      }
      s_s[e] = s;
    }
    __syncthreads();
    softmax_rows(s_s, chunk, m_s, l_s, a_s, rows, n);
    __syncthreads();
    accumulate_pv<D>(acc_s, s_s, chunk, a_s, v_s, rows, n);
  }
  __syncthreads();

  // ---- output: only this row's own tokens ------------------------------
  for (int e = threadIdx.x; e < rows * D; e += blockDim.x) {
    const int i = e / D, d = e % D;
    const float l = l_s[i];
    const float o = acc_s[e] / (l > 0.f ? l : 1.f);
    const size_t dst =
        ((size_t)(base + tok0 + i / group) * H + g * group + i % group) * D +
        d;
    out[dst] = from_float<T>(o);
  }
}

template <typename T, typename TP, int D>
cudaError_t launch(const void* q, const void* k_new, const void* v_new,
                   const void* k_pages, const void* v_pages,
                   const float* k_scale, const float* v_scale, const int* t0,
                   const int* q_len, const int* hist, const int* tables,
                   void* out, int T_tokens, int H, int KVH, int N, int P,
                   int R, int maxP, int layer, float scale,
                   cudaStream_t stream) {
  const int group = H / KVH;
  const int chunk = P < kMaxChunk ? P : kMaxChunk;
  const size_t smem = smem_floats<D>(group, chunk) * sizeof(float);
  auto kern = ragged_kernel<T, TP, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((T_tokens + kTileTokens - 1) / kTileTokens, KVH, R);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_new),
      static_cast<const T*>(v_new), static_cast<const TP*>(k_pages),
      static_cast<const TP*>(v_pages), k_scale, v_scale, t0, q_len, hist,
      tables, static_cast<T*>(out), H, KVH, N, P, maxP, layer, chunk, scale);
  return cudaGetLastError();
}

template <typename T, typename TP>
cudaError_t dispatch_d(int D, const void* q, const void* k_new,
                       const void* v_new, const void* k_pages,
                       const void* v_pages, const float* k_scale,
                       const float* v_scale, const int* t0, const int* q_len,
                       const int* hist, const int* tables, void* out,
                       int n_tokens, int H, int KVH, int N, int P, int R,
                       int maxP, int layer, float scale, cudaStream_t s) {
#define HELIX_K1_CASE(DIM)                                                  \
  case DIM:                                                                 \
    return launch<T, TP, DIM>(q, k_new, v_new, k_pages, v_pages, k_scale,  \
                              v_scale, t0, q_len, hist, tables, out,        \
                              n_tokens, H, KVH, N, P, R, maxP, layer,       \
                              scale, s);
  switch (D) {
    HELIX_K1_CASE(16)
    HELIX_K1_CASE(32)
    HELIX_K1_CASE(64)
    HELIX_K1_CASE(96)
    HELIX_K1_CASE(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef HELIX_K1_CASE
}

}  // namespace
}  // namespace helix

// dtype: 0 = float32, 1 = bfloat16.  Every pointer is a device pointer;
// q/out are [T, H, D], k_new/v_new [T, KVH, D], pools [L, N, P, KVH, D] of
// the same dtype, t0/q_len/hist [R] int32, tables [R, maxP] int32, all
// contiguous.
extern "C" int helix_ragged_paged_attention(
    const void* q, const void* k_new, const void* v_new, const void* k_pages,
    const void* v_pages, const void* t0, const void* q_len, const void* hist,
    const void* tables, void* out, int T, int H, int KVH, int D, int N,
    int P, int R, int maxP, int layer, float scale, int dtype,
    void* stream) {
  using namespace helix;
  const auto* t0i = static_cast<const int*>(t0);
  const auto* qli = static_cast<const int*>(q_len);
  const auto* hi = static_cast<const int*>(hist);
  const auto* tbl = static_cast<const int*>(tables);
  auto s = static_cast<cudaStream_t>(stream);
  if (T <= 0 || R <= 0) return cudaSuccess;
  if (H % KVH != 0) return cudaErrorInvalidValue;
  cudaError_t err;
  if (dtype == 0) {
    err = dispatch_d<float, float>(D, q, k_new, v_new, k_pages, v_pages,
                                   nullptr, nullptr, t0i, qli, hi, tbl, out,
                                   T, H, KVH, N, P, R, maxP, layer, scale, s);
  } else if (dtype == 1) {
    err = dispatch_d<__nv_bfloat16, __nv_bfloat16>(
        D, q, k_new, v_new, k_pages, v_pages, nullptr, nullptr, t0i, qli, hi,
        tbl, out, T, H, KVH, N, P, R, maxP, layer, scale, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// The int8-pool form: as above with int8 pools [L, N, P, KVH, D] and their
// float32 scale pools k_scale/v_scale [L, N, P, KVH]; dtype names the
// query / fresh K/V / output type.
extern "C" int helix_ragged_paged_attention_int8(
    const void* q, const void* k_new, const void* v_new, const void* k_pages,
    const void* v_pages, const void* k_scale, const void* v_scale,
    const void* t0, const void* q_len, const void* hist, const void* tables,
    void* out, int T, int H, int KVH, int D, int N, int P, int R, int maxP,
    int layer, float scale, int dtype, void* stream) {
  using namespace helix;
  const auto* t0i = static_cast<const int*>(t0);
  const auto* qli = static_cast<const int*>(q_len);
  const auto* hi = static_cast<const int*>(hist);
  const auto* tbl = static_cast<const int*>(tables);
  const auto* ks = static_cast<const float*>(k_scale);
  const auto* vs = static_cast<const float*>(v_scale);
  auto s = static_cast<cudaStream_t>(stream);
  if (T <= 0 || R <= 0) return cudaSuccess;
  if (H % KVH != 0) return cudaErrorInvalidValue;
  cudaError_t err;
  if (dtype == 0) {
    err = dispatch_d<float, int8_t>(D, q, k_new, v_new, k_pages, v_pages, ks,
                                    vs, t0i, qli, hi, tbl, out, T, H, KVH, N,
                                    P, R, maxP, layer, scale, s);
  } else if (dtype == 1) {
    err = dispatch_d<__nv_bfloat16, int8_t>(
        D, q, k_new, v_new, k_pages, v_pages, ks, vs, t0i, qli, hi, tbl, out,
        T, H, KVH, N, P, R, maxP, layer, scale, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
