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
// 989 TFLOP/s bf16.  (Short packed batches, S=512, are bound by bytes.)
//
// Two forms, split by dtype:
//
// * bfloat16 (the serving path): tensor cores.  One block of one
//   warpgroup (128 threads) per (64-query tile, head, batch row).  64 rows
//   is wgmma's M; with one warpgroup per block the phase-4 shape (packed
//   S=512, 32 heads) gives 256 blocks, enough for the 132 SMs, where
//   128-row tiles would give 128.  Q stays in shared memory for the whole
//   block; K and V tiles of 64 keys move into a 2-stage ring of bf16
//   shared memory with 16-byte cp.async copies (zero-filled past the
//   ragged edge), the next live tile loading while the current one
//   computes.  cp.async and not TMA: the copies are issued by the
//   computing warpgroup itself, need no tensor map (cuTensorMapEncodeTiled),
//   and a masked copy gives the zero fill the edge needs.  Every tile is
//   stored 128-byte swizzled in 64-column halves (head dims 16-64 pad to
//   64 columns, 96 and 128 to 128; the padding is zeroed once, so padded
//   Q/K columns add 0 to every score and padded V columns are never
//   stored).  S = Q K^T is wgmma m64n64k16 with both operands in shared
//   memory, K-major.  The softmax runs on the accumulator fragment in
//   registers (exp2 with scale * log2 e folded in, row max and sum over
//   the four threads of a quad); only tiles that straddle the diagonal, a
//   segment boundary or the ragged edge are masked.  P is rounded to bf16
//   in registers, as the TPU kernel rounds it to V's dtype
//   (attention.py:165-166), and feeds the second wgmma (m64n{64,128}k16)
//   as its register A operand; V is the B operand read [key][d], i.e.
//   MN-major (the transpose flag).  l sums the f32 p before rounding
//   (attention.py:164).  The output is rounded once and leaves through
//   shared memory in 16-byte stores.  Tiles are skipped exactly: when
//   max(qpos) < min(kpos) (the reference's causal skip) and when the
//   tile's segment range does not meet the query tile's (packed prompts
//   make most off-diagonal tiles segment-disjoint).
//
// * float32 (off the serving path): wgmma has no exact f32 input, so this
//   form keeps the first design unchanged: shared-memory FMA loops, one
//   block per (64-query tile, head, batch row), KV tiles of 32, the same
//   causal tile skip.

#include <limits.h>

#include "common.cuh"
#include "hopper.cuh"

namespace helix {
namespace {

// ---------------------------------------------------------------------------
// float32: the first design
// ---------------------------------------------------------------------------

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

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       const int* qpos, const int* kpos, const int* qseg,
                       const int* kseg, void* out, int B, int Sq, int Skv,
                       int H, int KVH, int causal, float scale,
                       float soft_cap, cudaStream_t stream, int* info) {
  const size_t smem = flash_smem_bytes<D>();
  auto kern = flash_kernel<float, D>;
  if (info) return kernel_info(kern, kThreads, smem, info);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), qpos, kpos, qseg, kseg,
      static_cast<float*>(out), Sq, Skv, H, KVH, causal, scale, soft_cap);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16: wgmma
// ---------------------------------------------------------------------------

constexpr int kWgThreads = 128;   // one consumer warpgroup
constexpr int kTile = 64;         // query rows per block = keys per KV tile

// Shared memory of the bf16 form, in bytes from a 1024-aligned base: Q,
// K[2], V[2] (each [64 rows][DP] bf16 as DP/64 swizzled halves of 8 KB),
// then kpos[2][64] and kseg[2][64], then (kAlloc onwards, sized per
// launch) one int4 per KV tile: its min/max position and segment.
template <int DP>
struct WgSmem {
  static constexpr int kTileBytes = kTile * DP * 2;
  static constexpr int kQ = 0;
  static constexpr int kK = kTileBytes;
  static constexpr int kV = 3 * kTileBytes;
  static constexpr int kMeta = 5 * kTileBytes;
  static constexpr int kBytes = kMeta + 4 * kTile * (int)sizeof(int);
  static constexpr int kAlloc = kBytes + 1024;   // alignment slack
};

__device__ __forceinline__ int warp_min(int x) {
#pragma unroll
  for (int o = 16; o; o >>= 1) x = min(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ int warp_max(int x) {
#pragma unroll
  for (int o = 16; o; o >>= 1) x = max(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Rows [row0, row0 + 64) of src[B, S, heads, D] for one head, 16-byte
// cp.async into a swizzled tile; rows at or past S are zero-filled.
__device__ __forceinline__ void stage_rows(uint8_t* tile,
                                           const __nv_bfloat16* src, int b,
                                           int row0, int S, int heads,
                                           int head, int D) {
  const int nch = D >> 3;
  for (int e = threadIdx.x; e < kTile * nch; e += kWgThreads) {
    const int row = e / nch, c = e - row * nch;
    const int gr = row0 + row;
    const bool ok = gr < S;
    const __nv_bfloat16* p =
        src + (((size_t)b * S + (ok ? gr : 0)) * heads + head) * D + c * 8;
    cp_async16(tile + sw128_offset(row, c, kTile), p, ok ? 16 : 0);
  }
}

template <int DP>
__global__ void __launch_bounds__(kWgThreads)
flash_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   const int* __restrict__ qpos, const int* __restrict__ kpos,
                   const int* __restrict__ qseg, const int* __restrict__ kseg,
                   __nv_bfloat16* __restrict__ out, int Sq, int Skv, int H,
                   int KVH, int D, int causal, float scale, float soft_cap) {
  using S = WgSmem<DP>;
  constexpr int kTB = S::kTileBytes;
  constexpr int kChunks = DP / 8;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* q_s = sm + S::kQ;
  uint8_t* k_s = sm + S::kK;
  uint8_t* v_s = sm + S::kV;
  int* kpos_s = reinterpret_cast<int*>(sm + S::kMeta);   // [2][64]
  int* kseg_s = kpos_s + 2 * kTile;                       // [2][64]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const bool use_seg = qseg != nullptr;
  const int nch = D >> 3;
  const int nkt = (Skv + kTile - 1) / kTile;

  // padded columns of Q, K[2], V[2]: zero once, cp.async never writes them
  const int npad = kChunks - nch;
  for (int e = tid; e < 5 * kTile * npad; e += kWgThreads) {
    const int t = e / (kTile * npad), rem = e - t * kTile * npad;
    const int row = rem / npad, c = nch + rem % npad;
    *reinterpret_cast<uint4*>(sm + t * kTB + sw128_offset(row, c, kTile)) =
        make_uint4(0u, 0u, 0u, 0u);
  }

  // the query tile's position and segment ranges (every warp computes the
  // same values, so the tile decisions below agree across the warpgroup)
  int qmin = INT_MAX, qmax = INT_MIN, qsmin = INT_MAX, qsmax = INT_MIN;
  for (int i = lane; i < kTile; i += 32) {
    if (q0 + i < Sq) {
      const size_t o = (size_t)b * Sq + q0 + i;
      const int p = qpos[o];
      qmin = min(qmin, p);
      qmax = max(qmax, p);
      if (use_seg) {
        const int s = qseg[o];
        qsmin = min(qsmin, s);
        qsmax = max(qsmax, s);
      }
    }
  }
  qmin = warp_min(qmin);
  qmax = warp_max(qmax);
  qsmin = use_seg ? warp_min(qsmin) : 0;
  qsmax = use_seg ? warp_max(qsmax) : 0;

  // this thread's two accumulator rows
  const int r0 = warp * 16 + (lane >> 2), r1 = r0 + 8;
  const bool ok0 = q0 + r0 < Sq, ok1 = q0 + r1 < Sq;
  const int qp0 = ok0 ? qpos[(size_t)b * Sq + q0 + r0] : 0;
  const int qp1 = ok1 ? qpos[(size_t)b * Sq + q0 + r1] : 0;
  const int qs0 = (use_seg && ok0) ? qseg[(size_t)b * Sq + q0 + r0] : 0;
  const int qs1 = (use_seg && ok1) ? qseg[(size_t)b * Sq + q0 + r1] : 0;

  // every KV tile's position and segment range, once, into shared memory
  // (the loads of four tiles are in flight together)
  int4* tstat = reinterpret_cast<int4*>(sm + S::kAlloc);
  stage_rows(q_s, q, b, q0, Sq, H, h, D);   // Q lands meanwhile
  cp_async_commit();
  constexpr int kU = 4, kWarpsK2 = kWgThreads / 32;
  for (int tb = warp; tb < nkt; tb += kWarpsK2 * kU) {
    int kp[kU][2], ks[kU][2];
    bool ok[kU][2];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = (tb + kWarpsK2 * u) * kTile + lane + 32 * e;
        ok[u][e] = tb + kWarpsK2 * u < nkt && key < Skv;
        const size_t o = (size_t)b * Skv + (ok[u][e] ? key : 0);
        kp[u][e] = kpos[o];
        ks[u][e] = use_seg ? kseg[o] : 0;
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int kmin = warp_min(min(ok[u][0] ? kp[u][0] : INT_MAX,
                                    ok[u][1] ? kp[u][1] : INT_MAX));
      const int kmax = warp_max(max(ok[u][0] ? kp[u][0] : INT_MIN,
                                    ok[u][1] ? kp[u][1] : INT_MIN));
      const int ksmin = warp_min(min(ok[u][0] ? ks[u][0] : INT_MAX,
                                     ok[u][1] ? ks[u][1] : INT_MAX));
      const int ksmax = warp_max(max(ok[u][0] ? ks[u][0] : INT_MIN,
                                     ok[u][1] ? ks[u][1] : INT_MIN));
      const int t = tb + kWarpsK2 * u;
      if (lane == 0 && t < nkt) tstat[t] = make_int4(kmin, kmax, ksmin, ksmax);
    }
  }
  __syncthreads();

  // KV tile j: live (not skipped) and full (no element needs a mask)
  auto tile_live = [&](int j, bool& full) -> bool {
    const int k0 = j * kTile;
    const int4 ts = tstat[j];
    const int kmin = ts.x, kmax = ts.y;
    const int ksmin = use_seg ? ts.z : 0, ksmax = use_seg ? ts.w : 0;
    const bool live = !(causal && qmax < kmin) &&
                      !(use_seg && (qsmax < ksmin || qsmin > ksmax));
    full = k0 + kTile <= Skv && (!causal || qmin >= kmax) &&
           (!use_seg || (qsmin == qsmax && ksmin == ksmax && qsmin == ksmin));
    return live;
  };
  auto next_live = [&](int j, bool& full) -> int {
    while (j < nkt && !tile_live(j, full)) ++j;
    return j;
  };
  auto stage_kv = [&](int j, int st) {
    stage_rows(k_s + st * kTB, k, b, j * kTile, Skv, KVH, kvh, D);
    stage_rows(v_s + st * kTB, v, b, j * kTile, Skv, KVH, kvh, D);
    // the tile's positions and segments, asynchronously too
    const int i = tid & (kTile - 1), kj = j * kTile + i;
    const bool ok = kj < Skv;
    const size_t o = (size_t)b * Skv + (ok ? kj : 0);
    if (tid < kTile) {
      cp_async4(kpos_s + st * kTile + i, kpos + o, ok ? 4 : 0);
    } else if (use_seg) {
      cp_async4(kseg_s + st * kTile + i, kseg + o, ok ? 4 : 0);
    }
  };

  bool full = false;
  int j = next_live(0, full);
  if (j < nkt) stage_kv(j, 0);
  cp_async_commit();

  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  const float sl2 = scale * kLog2e;
  int st = 0;

  while (j < nkt) {
    bool full_next = false;
    const int jn = next_live(j + 1, full_next);
    if (jn < nkt) stage_kv(jn, st ^ 1);   // overlaps this tile's compute
    cp_async_commit();
    cp_async_wait<1>();
    fence_proxy_async();
    __syncthreads();

    // S = Q K^T over DP / 16 steps of k16
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const int off = (kk >> 2) * kTile * 128 + (kk & 3) * 32;
      wgmma_ss_m64n64k16(s, sw128_desc(q_s + off, 16, 1024),
                         sw128_desc(k_s + st * kTB + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    // softmax on the fragment: s[4c + e] is row r0 (e < 2) or r1 (e >= 2),
    // column 8c + 2 (lane % 4) + (e & 1)
    const int* kp = kpos_s + st * kTile;
    const int* ks = kseg_s + st * kTile;
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float x = s[i];
      x = soft_cap > 0.f ? soft_cap * tanhf(x * scale / soft_cap) * kLog2e
                         : x * sl2;
      if (!full) {
        const int col = ((i >> 2) << 3) + ((lane & 3) << 1) + (i & 1);
        bool ok = j * kTile + col < Skv;
        if (causal) ok = ok && ((i & 2) ? qp1 : qp0) >= kp[col];
        if (use_seg) ok = ok && ((i & 2) ? qs1 : qs0) == ks[col];
        if (!ok) x = kMaskValue;
      }
      s[i] = x;
      if (i & 2) mx1 = fmaxf(mx1, x); else mx0 = fmaxf(mx0, x);
    }
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    const float al0 = exp2f(m0 - mx0), al1 = exp2f(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float p = exp2f(s[i] - ((i & 2) ? m1 : m0));
      s[i] = p;
      if (i & 2) rs1 += p; else rs0 += p;
    }
    l0 = l0 * al0 + rs0;   // this thread's share; summed over the quad last
    l1 = l1 * al1 + rs1;
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] *= (i & 2) ? al1 : al0;

    // O += P V: P rounded to bf16 as the register A operand
    uint32_t a[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r)
        a[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
    }
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t db =
          sw128_desc(v_s + st * kTB + kk * 16 * 128, kTile * 128, 1024);
      if constexpr (DP == 128) {
        wgmma_rs_m64n128k16(acc, a[kk], db);
      } else {
        wgmma_rs_m64n64k16(acc, a[kk], db);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    __syncthreads();   // stage st consumed before it is loaded again
    st ^= 1;
    j = jn;
    full = full_next;
  }

  // epilogue: O / l rounded once, through shared memory (Q's tile) so the
  // global stores are 16 bytes
  cp_async_wait<0>();
  __syncthreads();
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const float inv0 = l0 == 0.f ? 0.f : 1.f / l0;
  const float inv1 = l1 == 0.f ? 0.f : 1.f / l1;
#pragma unroll
  for (int c = 0; c < DP / 8; ++c) {
    const int col = c * 8 + ((lane & 3) << 1);
    const uint32_t o = (col & 7) * 2;
    *reinterpret_cast<uint32_t*>(q_s + sw128_offset(r0, c, kTile) + o) =
        pack_bf16(acc[4 * c] * inv0, acc[4 * c + 1] * inv0);
    *reinterpret_cast<uint32_t*>(q_s + sw128_offset(r1, c, kTile) + o) =
        pack_bf16(acc[4 * c + 2] * inv1, acc[4 * c + 3] * inv1);
  }
  __syncthreads();
  for (int e = tid; e < kTile * nch; e += kWgThreads) {
    const int row = e / nch, c = e - row * nch;
    if (q0 + row < Sq) {
      *reinterpret_cast<uint4*>(out + (((size_t)b * Sq + q0 + row) * H + h) *
                                          D + c * 8) =
          *reinterpret_cast<const uint4*>(q_s +
                                          sw128_offset(row, c, kTile));
    }
  }
}

template <int DP>
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        const int* qpos, const int* kpos, const int* qseg,
                        const int* kseg, void* out, int B, int Sq, int Skv,
                        int H, int KVH, int D, int causal, float scale,
                        float soft_cap, cudaStream_t stream, int* info) {
  const int nkt = (Skv + kTile - 1) / kTile;
  const size_t smem = WgSmem<DP>::kAlloc + (size_t)nkt * sizeof(int4);
  auto kern = flash_wgmma_kernel<DP>;
  if (info) return kernel_info(kern, kWgThreads, smem, info);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kTile - 1) / kTile, H, B);
  kern<<<grid, kWgThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), qpos, kpos, qseg, kseg,
      static_cast<__nv_bfloat16*>(out), Sq, Skv, H, KVH, D, causal, scale,
      soft_cap);
  return cudaGetLastError();
}

cudaError_t dispatch(int D, int dtype, const void* q, const void* k,
                     const void* v, const int* qpos, const int* kpos,
                     const int* qseg, const int* kseg, void* out, int B,
                     int Sq, int Skv, int H, int KVH, int causal,
                     float scale, float soft_cap, cudaStream_t s,
                     int* info) {
  if (dtype == 1) {
    if (D != 16 && D != 32 && D != 64 && D != 96 && D != 128)
      return cudaErrorInvalidValue;
    if (D <= 64)
      return launch_bf16<64>(q, k, v, qpos, kpos, qseg, kseg, out, B, Sq,
                             Skv, H, KVH, D, causal, scale, soft_cap, s,
                             info);
    return launch_bf16<128>(q, k, v, qpos, kpos, qseg, kseg, out, B, Sq, Skv,
                            H, KVH, D, causal, scale, soft_cap, s, info);
  }
  if (dtype != 0) return cudaErrorInvalidValue;
#define HELIX_K2_CASE(DIM)                                                 \
  case DIM:                                                                \
    return launch_f32<DIM>(q, k, v, qpos, kpos, qseg, kseg, out, B, Sq,   \
                           Skv, H, KVH, causal, scale, soft_cap, s, info);
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
  if (B <= 0 || Sq <= 0) return cudaSuccess;
  if (Skv <= 0 || H % KVH != 0) return cudaErrorInvalidValue;
  return static_cast<int>(helix::dispatch(
      D, dtype, q, k, v, static_cast<const int*>(qpos),
      static_cast<const int*>(kpos), static_cast<const int*>(qseg),
      static_cast<const int*>(kseg), out, B, Sq, Skv, H, KVH, causal, scale,
      soft_cap, static_cast<cudaStream_t>(stream), nullptr));
}

// The launch resources of the kernel the call above would launch for
// head dim D and dtype: info[4] = shared memory per block (bytes),
// registers per thread, blocks per SM, spill bytes per thread.
extern "C" int helix_flash_attention_info(int D, int dtype, int* info) {
  return static_cast<int>(helix::dispatch(
      D, dtype, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
      nullptr, nullptr, 1, 1, 1, 1, 1, 1, 1.f, 0.f, nullptr, info));
}
