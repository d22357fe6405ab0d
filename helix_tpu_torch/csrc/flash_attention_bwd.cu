// K2-backward: dQ, dK and dV of K2's attention, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the TPU flash_attention
// (helix_tpu/ops/attention.py) has no custom_vjp, and the reference's
// trainer (helix_tpu/training/sft.py, loss_fn) differentiates through
// attention() with XLA.  It is the gradient of K2's function: q[B, Sq, H,
// D] against k/v[B, Skv, KVH, D] (GQA: head h reads KV head h / (H /
// KVH)), causal by positions (qpos >= kpos), equal segment ids when given,
// logits = scale * q.k, then the tanh soft cap when soft_cap > 0.  Inputs
// are float32 or bfloat16; every sum is float32 and each gradient rounds
// once to the input dtype.
//
// Given O and each row's log-sum-exp (K2 writes it, f32 [B, H, Sq]):
//
//   Delta = rowsum(dO * O)                                  (pre-pass)
//   P     = exp(cap(scale q.k) - lse)      (0 where masked; lse = +inf for
//                                            a row with no live key)
//   dP    = dO . v
//   dS    = P * (dP - Delta) * cap' * scale, cap' = 1 - tanh^2 (1 uncapped)
//   dV    = sum over the group's heads and queries of P^T dO
//   dK    = sum over the group's heads and queries of dS^T q
//   dQ    = dS k
//
// What bounds it on the H100: operations.  At the training shapes (S 1024,
// 64-row tiles) each staged tile is reused by 64 rows, and the work (8 D
// multiply-adds per live (query, key, head) triple, twice that in FLOPs)
// is far past the bytes of q, k, v, O, dO and the three gradients.
//
// This first design is simple and deterministic: CUDA-core FMA in f32
// (the backward recomputes P in f32 and never rounds it, as the plain
// version's autograd does not), no atomics, so a gradient is the same from
// run to run.  Three launches on the caller's stream:
//
// * the Delta pre-pass, one warp per (batch, query, head) row;
// * dK/dV: one block of 256 threads per (64-key tile, KV head, batch row).
//   K and V stay in shared memory; the block loops over the query heads of
//   its group and over the query tiles, stages Q and dO, computes S and dP
//   as 4x4 register blocks per thread, writes P and dS to shared memory and
//   accumulates dV += P^T dO and dK += dS^T Q in registers (4 keys x D/16
//   columns a thread); dK and dV are written once;
// * dQ: one block per (64-query tile, head, batch row) over the KV tiles,
//   dQ += dS K in registers.
//
// Tiles are skipped exactly when no (query, key) pair of them is live: the
// causal skip (max qpos < min kpos) and disjoint segment ranges, as K2's
// forward skips.  Tiles are [64][D + 1] floats (the +1 keeps the column
// reads of a warp on distinct banks), ~167 KB of shared memory at D 128:
// one block per SM.  Tensor cores (wgmma), TMA and a smaller footprint are
// later work.
//
// `drop_cap_derivative` plants the one defect that the checks cannot make
// through the inputs (0 on every real call): dS without the cap's
// derivative 1 - tanh^2.  P is recomputed from the capped scores, so no
// input leaves P as it is and cap' at 1.

#include <limits.h>

#include "common.cuh"

namespace helix {
namespace {

constexpr int kBwdThreads = 256;
constexpr int kBT = 64;   // query rows per query tile = keys per KV tile
constexpr int kPL = kBT + 1;

template <int D>
struct BwdSmem {
  static constexpr int kDP = D + 1;
  static constexpr int kTile = kBT * kDP;   // floats of one [64][D + 1] tile
  static constexpr int kQ = 0;
  static constexpr int kDO = kTile;
  static constexpr int kK = 2 * kTile;
  static constexpr int kV = 3 * kTile;
  static constexpr int kP = 4 * kTile;
  static constexpr int kDS = kP + kBT * kPL;
  static constexpr int kLse = kDS + kBT * kPL;
  static constexpr int kDl = kLse + kBT;
  static constexpr int kFloats = kDl + kBT;
  // ints after the floats: qpos, qseg, kpos, kseg [64] and two ranges
  static constexpr int kInts = 4 * kBT + 8;
  static constexpr size_t kBytes =
      (size_t)kFloats * sizeof(float) + (size_t)kInts * sizeof(int);
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

// Delta[b, h, i] = sum_d dO[b, i, h, d] * O[b, i, h, d], one warp a row.
template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                       float* __restrict__ delta, long rows, int Sq, int H,
                       int D) {
  const long row = (long)blockIdx.x * (kBwdThreads / 32) + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const T* po = o + row * D;
  const T* pd = dout + row * D;
  float s = 0.f;
  for (int d = lane; d < D; d += 32) s += to_float(po[d]) * to_float(pd[d]);
#pragma unroll
  for (int off = 16; off; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) {
    // row = (b * Sq + i) * H + h, the memory order of O
    const int h = (int)(row % H);
    const long bi = row / H;
    const int i = (int)(bi % Sq);
    const long b = bi / Sq;
    delta[(b * H + h) * Sq + i] = s;
  }
}

// Rows [row0, row0 + 64) of src[B, S, heads, D] for one head into a
// [64][D + 1] f32 tile; rows at or past S are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int b,
                                          int row0, int S, int heads,
                                          int head) {
  constexpr int DP = D + 1;
  for (int e = threadIdx.x; e < kBT * D; e += kBwdThreads) {
    const int i = e / D, d = e - (e / D) * D;
    const int r = row0 + i;
    dst[i * DP + d] =
        r < S ? to_float(src[(((size_t)b * S + r) * heads + head) * D + d])
              : 0.f;
  }
}

__device__ __forceinline__ void load_meta(int* pos_s, int* seg_s,
                                          const int* pos, const int* seg,
                                          int b, int row0, int S) {
  for (int i = threadIdx.x; i < kBT; i += kBwdThreads) {
    const int r = row0 + i;
    const bool ok = r < S;
    pos_s[i] = ok ? pos[(size_t)b * S + r] : 0;
    seg_s[i] = (ok && seg != nullptr) ? seg[(size_t)b * S + r] : 0;
  }
}

// The position and segment ranges of a tile's n valid rows, by warp 0:
// red = {min pos, max pos, min seg, max seg}.  Read after a barrier.
__device__ __forceinline__ void tile_range(const int* pos_s,
                                           const int* seg_s, int n,
                                           int* red) {
  if (threadIdx.x >= 32) return;
  int pmin = INT_MAX, pmax = INT_MIN, smin = INT_MAX, smax = INT_MIN;
  for (int i = threadIdx.x; i < n; i += 32) {
    pmin = min(pmin, pos_s[i]);
    pmax = max(pmax, pos_s[i]);
    smin = min(smin, seg_s[i]);
    smax = max(smax, seg_s[i]);
  }
  pmin = warp_min(pmin);
  pmax = warp_max(pmax);
  smin = warp_min(smin);
  smax = warp_max(smax);
  if (threadIdx.x == 0) {
    red[0] = pmin;
    red[1] = pmax;
    red[2] = smin;
    red[3] = smax;
  }
}

// Whether any (query, key) pair of two tiles can be live.
__device__ __forceinline__ bool tiles_meet(const int* qr, const int* kr,
                                           bool causal, bool use_seg) {
  if (causal && qr[1] < kr[0]) return false;
  if (use_seg && (qr[3] < kr[2] || qr[2] > kr[3])) return false;
  return true;
}

// acc[4 r + c] = sum_d a[4 ty + r][d] * b[tx + 16 c][d] over [64][D + 1]
// tiles: this thread's 4x4 block of a 64x64 product.
template <int D>
__device__ __forceinline__ void dot4x4(const float* a, const float* b,
                                       int ty, int tx, float (&acc)[16]) {
  constexpr int DP = D + 1;
#pragma unroll
  for (int e = 0; e < 16; ++e) acc[e] = 0.f;
  const float* a0 = a + 4 * ty * DP;
  const float* b0 = b + tx * DP;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float av[4], bv[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) av[r] = a0[r * DP + d];
#pragma unroll
    for (int c = 0; c < 4; ++c) bv[c] = b0[16 * c * DP + d];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        acc[4 * r + c] = fmaf(av[r], bv[c], acc[4 * r + c]);
  }
}

struct BwdShape {
  int Sq, Skv, H, KVH;
  float scale, soft_cap;
  bool causal, use_seg, keep_capd;
};

// P and dS of this thread's 4x4 block (rows 4 ty + r, columns tx + 16 c)
// from its S and dP blocks; masked and out-of-range pairs give 0.
__device__ __forceinline__ void probs_and_grads(
    const BwdShape& sh, const float (&s)[16], const float (&dp)[16],
    const float* lse_s, const float* dl_s, const int* qpos_s,
    const int* qseg_s, const int* kpos_s, const int* kseg_s, int qrows,
    int krows, int ty, int tx, float (&p)[16], float (&ds)[16]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = 4 * ty + r;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = tx + 16 * c, e = 4 * r + c;
      bool live = i < qrows && j < krows;
      if (sh.causal) live = live && qpos_s[i] >= kpos_s[j];
      if (sh.use_seg) live = live && qseg_s[i] == kseg_s[j];
      float x = s[e] * sh.scale, capd = 1.f;
      if (sh.soft_cap > 0.f) {
        const float t = tanhf(x / sh.soft_cap);
        x = sh.soft_cap * t;
        if (sh.keep_capd) capd = 1.f - t * t;
      }
      const float pe = live ? expf(x - lse_s[i]) : 0.f;
      p[e] = pe;
      ds[e] = pe * (dp[e] - dl_s[i]) * capd * sh.scale;
    }
  }
}

// Row i of a query tile's lse and Delta, +inf / 0 past the last row.
__device__ __forceinline__ void load_row_stats(float* lse_s, float* dl_s,
                                               const float* lse,
                                               const float* delta, int b,
                                               int h, int H, int Sq, int q0,
                                               int qrows) {
  for (int i = threadIdx.x; i < kBT; i += kBwdThreads) {
    const bool ok = i < qrows;
    const size_t o = ((size_t)b * H + h) * Sq + q0 + i;
    lse_s[i] = ok ? lse[o] : INFINITY;
    dl_s[i] = ok ? delta[o] : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kBwdThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      const int* __restrict__ qpos,
                      const int* __restrict__ kpos,
                      const int* __restrict__ qseg,
                      const int* __restrict__ kseg, T* __restrict__ dk,
                      T* __restrict__ dv, BwdShape sh) {
  using L = BwdSmem<D>;
  constexpr int DP = D + 1, NC = D / 16;
  extern __shared__ float sm[];
  float* q_s = sm + L::kQ;
  float* do_s = sm + L::kDO;
  float* k_s = sm + L::kK;
  float* v_s = sm + L::kV;
  float* p_s = sm + L::kP;
  float* ds_s = sm + L::kDS;
  float* lse_s = sm + L::kLse;
  float* dl_s = sm + L::kDl;
  int* qpos_s = reinterpret_cast<int*>(sm + L::kFloats);
  int* qseg_s = qpos_s + kBT;
  int* kpos_s = qseg_s + kBT;
  int* kseg_s = kpos_s + kBT;
  int* krange = kseg_s + kBT;
  int* qrange = krange + 4;

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int k0 = blockIdx.x * kBT, kvh = blockIdx.y, b = blockIdx.z;
  const int Sq = sh.Sq, Skv = sh.Skv, H = sh.H, KVH = sh.KVH;
  const int krows = min(kBT, Skv - k0);
  const int G = H / KVH;
  const int hbase = kvh * G;   // the query heads that read this KV head

  load_tile<T, D>(k_s, k, b, k0, Skv, KVH, kvh);
  load_tile<T, D>(v_s, v, b, k0, Skv, KVH, kvh);
  load_meta(kpos_s, kseg_s, kpos, kseg, b, k0, Skv);
  __syncthreads();
  tile_range(kpos_s, kseg_s, krows, krange);

  float dka[4][NC], dva[4][NC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) dka[r][c] = dva[r][c] = 0.f;

  const int nqt = (Sq + kBT - 1) / kBT;
  for (int qt = 0; qt < nqt; ++qt) {
    const int q0 = qt * kBT, qrows = min(kBT, Sq - q0);
    __syncthreads();   // the last tile's readers are done; krange visible
    load_meta(qpos_s, qseg_s, qpos, qseg, b, q0, Sq);
    __syncthreads();
    tile_range(qpos_s, qseg_s, qrows, qrange);
    __syncthreads();
    if (!tiles_meet(qrange, krange, sh.causal, sh.use_seg)) continue;
    for (int g = 0; g < G; ++g) {
      const int h = hbase + g;
      if (g > 0) __syncthreads();   // the last head's readers are done
      load_tile<T, D>(q_s, q, b, q0, Sq, H, h);
      load_tile<T, D>(do_s, dout, b, q0, Sq, H, h);
      load_row_stats(lse_s, dl_s, lse, delta, b, h, H, Sq, q0, qrows);
      __syncthreads();
      float s[16], dp[16], p[16], ds[16];
      dot4x4<D>(q_s, k_s, ty, tx, s);
      dot4x4<D>(do_s, v_s, ty, tx, dp);
      probs_and_grads(sh, s, dp, lse_s, dl_s, qpos_s, qseg_s, kpos_s,
                      kseg_s, qrows, krows, ty, tx, p, ds);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int o = (4 * ty + r) * kPL + tx + 16 * c;
          p_s[o] = p[4 * r + c];
          ds_s[o] = ds[4 * r + c];
        }
      __syncthreads();
      // dV += P^T dO, dK += dS^T Q: this thread's keys 4 ty + r, columns
      // tx + 16 c
      for (int i = 0; i < qrows; ++i) {
        float pv[4], sv[4], ov[NC], qv[NC];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          pv[r] = p_s[i * kPL + 4 * ty + r];
          sv[r] = ds_s[i * kPL + 4 * ty + r];
        }
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          ov[c] = do_s[i * DP + tx + 16 * c];
          qv[c] = q_s[i * DP + tx + 16 * c];
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            dva[r][c] = fmaf(pv[r], ov[c], dva[r][c]);
            dka[r][c] = fmaf(sv[r], qv[c], dka[r][c]);
          }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int j = 4 * ty + r;
    if (j >= krows) continue;
    const size_t row = (((size_t)b * Skv + k0 + j) * KVH + kvh) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      dk[row + tx + 16 * c] = from_float<T>(dka[r][c]);
      dv[row + tx + 16 * c] = from_float<T>(dva[r][c]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kBwdThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const int* __restrict__ qpos,
                    const int* __restrict__ kpos,
                    const int* __restrict__ qseg,
                    const int* __restrict__ kseg, T* __restrict__ dq,
                    BwdShape sh) {
  using L = BwdSmem<D>;
  constexpr int DP = D + 1, NC = D / 16;
  extern __shared__ float sm[];
  float* q_s = sm + L::kQ;
  float* do_s = sm + L::kDO;
  float* k_s = sm + L::kK;
  float* v_s = sm + L::kV;
  float* ds_s = sm + L::kDS;
  float* lse_s = sm + L::kLse;
  float* dl_s = sm + L::kDl;
  int* qpos_s = reinterpret_cast<int*>(sm + L::kFloats);
  int* qseg_s = qpos_s + kBT;
  int* kpos_s = qseg_s + kBT;
  int* kseg_s = kpos_s + kBT;
  int* krange = kseg_s + kBT;
  int* qrange = krange + 4;

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int q0 = blockIdx.x * kBT, h = blockIdx.y, b = blockIdx.z;
  const int Sq = sh.Sq, Skv = sh.Skv, H = sh.H, KVH = sh.KVH;
  const int qrows = min(kBT, Sq - q0);
  const int kvh = h / (H / KVH);

  load_tile<T, D>(q_s, q, b, q0, Sq, H, h);
  load_tile<T, D>(do_s, dout, b, q0, Sq, H, h);
  load_row_stats(lse_s, dl_s, lse, delta, b, h, H, Sq, q0, qrows);
  load_meta(qpos_s, qseg_s, qpos, qseg, b, q0, Sq);
  __syncthreads();
  tile_range(qpos_s, qseg_s, qrows, qrange);

  float dqa[4][NC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) dqa[r][c] = 0.f;

  const int nkt = (Skv + kBT - 1) / kBT;
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * kBT, krows = min(kBT, Skv - k0);
    __syncthreads();   // the last tile's readers are done; qrange visible
    load_meta(kpos_s, kseg_s, kpos, kseg, b, k0, Skv);
    __syncthreads();
    tile_range(kpos_s, kseg_s, krows, krange);
    __syncthreads();
    if (!tiles_meet(qrange, krange, sh.causal, sh.use_seg)) continue;
    load_tile<T, D>(k_s, k, b, k0, Skv, KVH, kvh);
    load_tile<T, D>(v_s, v, b, k0, Skv, KVH, kvh);
    __syncthreads();
    float s[16], dp[16], p[16], ds[16];
    dot4x4<D>(q_s, k_s, ty, tx, s);
    dot4x4<D>(do_s, v_s, ty, tx, dp);
    probs_and_grads(sh, s, dp, lse_s, dl_s, qpos_s, qseg_s, kpos_s, kseg_s,
                    qrows, krows, ty, tx, p, ds);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        ds_s[(4 * ty + r) * kPL + tx + 16 * c] = ds[4 * r + c];
    __syncthreads();
    // dQ += dS K: this thread's queries 4 ty + r, columns tx + 16 c
    for (int j = 0; j < krows; ++j) {
      float sv[4], kv[NC];
#pragma unroll
      for (int r = 0; r < 4; ++r) sv[r] = ds_s[(4 * ty + r) * kPL + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) kv[c] = k_s[j * DP + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < NC; ++c)
          dqa[r][c] = fmaf(sv[r], kv[c], dqa[r][c]);
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = 4 * ty + r;
    if (i >= qrows) continue;
    const size_t row = (((size_t)b * Sq + q0 + i) * H + h) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) dq[row + tx + 16 * c] = from_float<T>(dqa[r][c]);
  }
}

struct BwdPtrs {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  const int *qpos, *kpos, *qseg, *kseg;
  void *dq, *dk, *dv;
  float* delta;
};

template <typename T, int D>
cudaError_t launch_bwd(const BwdPtrs& a, int B, const BwdShape& sh,
                       cudaStream_t stream, int which,
                       int* info) {
  const size_t smem = BwdSmem<D>::kBytes;
  auto kdkdv = flash_bwd_dkdv_kernel<T, D>;
  auto kdq = flash_bwd_dq_kernel<T, D>;
  if (info) {
    return which == 0 ? kernel_info(kdkdv, kBwdThreads, smem, info)
                      : kernel_info(kdq, kBwdThreads, smem, info);
  }
  cudaError_t err = cudaFuncSetAttribute(
      kdkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      kdq, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  const long rows = (long)B * sh.Sq * sh.H;
  const long per = kBwdThreads / 32;
  flash_bwd_delta_kernel<T><<<(unsigned)((rows + per - 1) / per),
                              kBwdThreads, 0, stream>>>(
      static_cast<const T*>(a.o), dout, a.delta, rows, sh.Sq, sh.H, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 gkv((sh.Skv + kBT - 1) / kBT, sh.KVH, B);
  kdkdv<<<gkv, kBwdThreads, smem, stream>>>(
      q, k, v, dout, a.lse, a.delta, a.qpos, a.kpos, a.qseg, a.kseg,
      static_cast<T*>(a.dk), static_cast<T*>(a.dv), sh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 gq((sh.Sq + kBT - 1) / kBT, sh.H, B);
  kdq<<<gq, kBwdThreads, smem, stream>>>(
      q, k, v, dout, a.lse, a.delta, a.qpos, a.kpos, a.qseg, a.kseg,
      static_cast<T*>(a.dq), sh);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const BwdPtrs& a, int B, const BwdShape& sh,
                       cudaStream_t s, int which, int* info) {
  switch (D) {
    case 16: return launch_bwd<T, 16>(a, B, sh, s, which, info);
    case 32: return launch_bwd<T, 32>(a, B, sh, s, which, info);
    case 64: return launch_bwd<T, 64>(a, B, sh, s, which, info);
    case 96: return launch_bwd<T, 96>(a, B, sh, s, which, info);
    case 128: return launch_bwd<T, 128>(a, B, sh, s, which, info);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch(int D, int dtype, const BwdPtrs& a, int B,
                     const BwdShape& sh, cudaStream_t s,
                     int which, int* info) {
  if (dtype == 0)
    return dispatch_d<float>(D, a, B, sh, s, which, info);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(D, a, B, sh, s, which, info);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace helix

// dtype: 0 = float32, 1 = bfloat16.  q/o/dout/dq [B, Sq, H, D], k/v/dk/dv
// [B, Skv, KVH, D], lse and the delta scratch f32 [B, H, Sq], qpos/qseg
// [B, Sq] and kpos/kseg [B, Skv] int32, all contiguous device memory;
// qseg/kseg may both be null (no segments).  soft_cap <= 0 disables the
// cap.  drop_cap_derivative: 0 (see the header).
extern "C" int helix_flash_attention_backward(
    const void* q, const void* k, const void* v, const void* o,
    const void* lse, const void* dout, const void* qpos, const void* kpos,
    const void* qseg, const void* kseg, void* dq, void* dk, void* dv,
    void* delta, int B, int Sq, int Skv, int H, int KVH, int D, int causal,
    float scale, float soft_cap, int dtype, int drop_cap_derivative,
    void* stream) {
  if (B <= 0 || Sq <= 0) return cudaSuccess;
  if (Skv <= 0 || KVH <= 0 || H % KVH != 0)
    return cudaErrorInvalidValue;
  helix::BwdPtrs a{q, k, v, o, dout, static_cast<const float*>(lse),
                   static_cast<const int*>(qpos),
                   static_cast<const int*>(kpos),
                   static_cast<const int*>(qseg),
                   static_cast<const int*>(kseg), dq, dk, dv,
                   static_cast<float*>(delta)};
  helix::BwdShape sh{Sq, Skv, H, KVH, scale, soft_cap,
                     causal != 0, qseg != nullptr, drop_cap_derivative == 0};
  return static_cast<int>(helix::dispatch(
      D, dtype, a, B, sh, static_cast<cudaStream_t>(stream), 0,
      nullptr));
}

// Launch resources of the dK/dV kernel (which 0) or the dQ kernel (which
// 1) for head dim D and dtype: info[4] = shared memory per block (bytes),
// registers per thread, blocks per SM, spill bytes per thread.
extern "C" int helix_flash_attention_backward_info(int D, int dtype,
                                                   int which, int* info) {
  helix::BwdPtrs a{};
  helix::BwdShape sh{1, 1, 1, 1, 1.f, 0.f, true, false, true};
  return static_cast<int>(
      helix::dispatch(D, dtype, a, 1, sh, nullptr, which, info));
}
