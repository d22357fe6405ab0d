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
// 64-row tiles) each staged tile is reused by 64 rows, and the work (2 D
// FLOPs per product per live (query, key, head) triple) is far past the
// bytes of q, k, v, O, dO and the three gradients.  (Short packed chats
// leave so few live pairs that the bytes bound it on paper.)
//
// Launches on the caller's stream: the Delta pre-pass (one warp per
// (batch, query, head) row), then the dK/dV kernel, then the dQ kernel
// (the bf16 form adds its tile map before them).  Neither uses atomics:
// dK and dV of a KV head are summed over its group inside one block, dQ
// of a query tile inside another, each in a fixed order, so a gradient is
// bit-equal from run to run.  The price is that the dQ kernel recomputes
// S and dP (seven products, not FA2's five with an atomic f32 dQ).  A
// tile is skipped only when no (query, key) pair of it is live.  Two
// forms, split by dtype:
//
// * bfloat16 (training): tensor cores.  One warpgroup (128 threads) per
//   block; every tile is 64 rows, 128-byte swizzled in 64-column halves
//   (head dims 16-64 pad to 64 columns, 96 and 128 to 128, the padding
//   zeroed once), loaded by 16-byte cp.async with zero fill past the
//   ragged edge into a 2-stage ring, the next live tile loading while the
//   current one computes.  Shared memory is six tiles (96 KB at D 128), so
//   two blocks share an SM.  All five products run as wgmma (bf16 in, f32
//   accumulate), as K2's forward runs its two:
//   - dK/dV per (64-key tile, KV head, batch row): K and V stay staged; Q,
//     dO, lse and Delta of each (head of the group, live query tile) move
//     through the ring.  The products are transposed so the keys are the
//     accumulator rows: S^T = K Q^T and dP^T = V dO^T with both operands
//     K-major in shared memory; P^T and dS^T on the fragments in f32 (lse
//     and Delta by column); dV += P^T dO and dK += dS^T Q with P^T and
//     dS^T rounded to bf16 in registers as the A operand and dO / Q read
//     [query][d] as the MN-major B operand, so the same staged tiles serve
//     both readings.  dK and dV stay in registers over the whole group and
//     are written once.  dV's product runs while dS^T is computed.
//   - dQ per (64-query tile, head, batch row): Q and dO stay staged; K and
//     V move through the ring.  S = Q K^T and dP = dO V^T (both K-major),
//     P on the fragment while dP runs, dS rounded to bf16 as the A operand
//     of dQ += dS K (K read [key][d], MN-major, as the forward reads V).
//   Which tiles to visit comes from a tile map, a pre-pass that ORs and
//   ANDs the 4096 masks of every (query tile, key tile) pair: a tile is
//   visited exactly when it holds a live pair and masked per element
//   exactly when it holds a dead one.  (Min / max ranges of positions and
//   segments cannot see that a tile of one chat and the padding, or of
//   two chats, meets another tile only through dead pairs: at the
//   training shape they visit 761 tile pairs a head where 519 are live.)
//   P is exp2 of one FFMA (scale log2 e folded, lse scaled by log2 e).
//   P and dS round to bf16 before their products
//   (the tensor cores take no f32 operand): each moves a gradient by at
//   most 2**-8 of the sum of its terms' magnitudes, which
//   flash_backward_error_limit adds for bf16 inputs.
//
// * float32: wgmma has no exact f32 input, so this form keeps the first
//   design: CUDA-core FMA in f32 on 4x4 register blocks, P recomputed in
//   f32 and never rounded, tiles skipped by the causal test on position
//   ranges and disjoint segment ranges, one block of 256 threads per
//   (64-key tile, KV head, batch row) for dK/dV (looping over the group's
//   heads and the query tiles, P and dS through shared memory) and per
//   (64-query tile, head, batch row) for dQ; [64][D + 1] f32 tiles (~167
//   KB at D 128, one block per SM).
//
// `drop_cap_derivative` plants the one defect that the checks cannot make
// through the inputs (0 on every real call): dS without the cap's
// derivative 1 - tanh^2.  P is recomputed from the capped scores, so no
// input leaves P as it is and cap' at 1.

#include <limits.h>

#include "common.cuh"
#include "hopper.cuh"

namespace helix {
namespace {

// ---------------------------------------------------------------------------
// float32: the first design (and what both forms share)
// ---------------------------------------------------------------------------

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
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src, int b,
                                          int row0, int S, int heads,
                                          int head) {
  constexpr int DP = D + 1;
  for (int e = threadIdx.x; e < kBT * D; e += kBwdThreads) {
    const int i = e / D, d = e - (e / D) * D;
    const int r = row0 + i;
    dst[i * DP + d] =
        r < S ? src[(((size_t)b * S + r) * heads + head) * D + d] : 0.f;
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

template <int D>
__global__ void __launch_bounds__(kBwdThreads)
flash_bwd_dkdv_kernel(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      const int* __restrict__ qpos,
                      const int* __restrict__ kpos,
                      const int* __restrict__ qseg,
                      const int* __restrict__ kseg, float* __restrict__ dk,
                      float* __restrict__ dv, BwdShape sh) {
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

  load_tile<D>(k_s, k, b, k0, Skv, KVH, kvh);
  load_tile<D>(v_s, v, b, k0, Skv, KVH, kvh);
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
      load_tile<D>(q_s, q, b, q0, Sq, H, h);
      load_tile<D>(do_s, dout, b, q0, Sq, H, h);
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
      dk[row + tx + 16 * c] = dka[r][c];
      dv[row + tx + 16 * c] = dva[r][c];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kBwdThreads)
flash_bwd_dq_kernel(const float* __restrict__ q,
                    const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const int* __restrict__ qpos,
                    const int* __restrict__ kpos,
                    const int* __restrict__ qseg,
                    const int* __restrict__ kseg, float* __restrict__ dq,
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

  load_tile<D>(q_s, q, b, q0, Sq, H, h);
  load_tile<D>(do_s, dout, b, q0, Sq, H, h);
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
    load_tile<D>(k_s, k, b, k0, Skv, KVH, kvh);
    load_tile<D>(v_s, v, b, k0, Skv, KVH, kvh);
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
    for (int c = 0; c < NC; ++c) dq[row + tx + 16 * c] = dqa[r][c];
  }
}

struct BwdPtrs {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  const int *qpos, *kpos, *qseg, *kseg;
  void *dq, *dk, *dv;
  float* delta;
  uint8_t* tile_map;   // bf16 form: 2 B nqt nkt bytes of scratch
};

template <typename T>
cudaError_t launch_delta(const BwdPtrs& a, int B, const BwdShape& sh, int D,
                         cudaStream_t stream) {
  const long rows = (long)B * sh.Sq * sh.H;
  const long per = kBwdThreads / 32;
  flash_bwd_delta_kernel<T><<<(unsigned)((rows + per - 1) / per),
                              kBwdThreads, 0, stream>>>(
      static_cast<const T*>(a.o), static_cast<const T*>(a.dout), a.delta,
      rows, sh.Sq, sh.H, D);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bwd_f32(const BwdPtrs& a, int B, const BwdShape& sh,
                           cudaStream_t stream, int which, int* info) {
  using T = float;
  const size_t smem = BwdSmem<D>::kBytes;
  auto kdkdv = flash_bwd_dkdv_kernel<D>;
  auto kdq = flash_bwd_dq_kernel<D>;
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
  err = launch_delta<T>(a, B, sh, D, stream);
  if (err != cudaSuccess) return err;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
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

// ---------------------------------------------------------------------------
// bfloat16: wgmma
// ---------------------------------------------------------------------------

constexpr int kWgThreads = 128;   // one warpgroup
constexpr int kTile = 64;         // rows of every staged tile (wgmma's M)

// Shared memory of the bf16 form, in bytes from a 1024-aligned base: two
// fixed tiles (dQ: Q, dO; dK/dV: K, V), then two 2-stage rings (dQ: K[2],
// V[2]; dK/dV: Q[2], dO[2]), each tile [64 rows][DP] bf16 as DP / 64
// swizzled halves of 8 KB; then the ring's per-stage meta: pos[2][64],
// seg[2][64] (int) and, for dK/dV, lse[2][64], Delta[2][64] (float); then
// (kBytes onwards, sized per launch) the block's row of the tile map, one
// byte per tile of the looped side.  A launch allocates kAlloc (the
// 1024-byte alignment slack included) plus those bytes.
template <int DP>
struct WgSmem {
  static constexpr int kTileBytes = kTile * DP * 2;
  static constexpr int kFix0 = 0;
  static constexpr int kFix1 = kTileBytes;
  static constexpr int kRing0 = 2 * kTileBytes;
  static constexpr int kRing1 = 4 * kTileBytes;
  static constexpr int kMeta = 6 * kTileBytes;
  static constexpr int kBytes = kMeta + 8 * kTile * 4;
  static constexpr int kAlloc = kBytes + 1024;   // alignment slack
};

// The tile map: for every (query tile, key tile) pair of a batch row,
// bit 0 set when some (query, key) pair of the two is live and bit 1 when
// every pair is (both tiles whole).  Each bit is the OR / AND over the
// tile pair's 4096 masks, so a tile is skipped exactly when it holds no
// live pair and masked exactly when it holds a dead one.  Written twice:
// by query tile, by_q[B][nqt][nkt] (the dQ kernel's row), and by key
// tile, by_k[B][nkt][nqt] (the dK/dV kernel's).  One block per tile pair:
// a thread per key and half of the query tile.
__global__ void __launch_bounds__(kWgThreads)
flash_bwd_tile_map_kernel(const int* __restrict__ qpos,
                          const int* __restrict__ kpos,
                          const int* __restrict__ qseg,
                          const int* __restrict__ kseg,
                          uint8_t* __restrict__ by_q,
                          uint8_t* __restrict__ by_k, BwdShape sh) {
  __shared__ int qp_s[kTile], qs_s[kTile];
  const int kt = blockIdx.x, qt = blockIdx.y, b = blockIdx.z;
  const int nkt = gridDim.x, nqt = gridDim.y;
  const int Sq = sh.Sq, Skv = sh.Skv;
  const int tid = threadIdx.x, j = tid & (kTile - 1);
  const int i0 = (tid >> 6) * (kTile / 2);
  const int kj = kt * kTile + j, q0 = qt * kTile;
  const int qrows = min(kTile, Sq - q0);
  const bool kok = kj < Skv;
  const int kp = kok ? kpos[(size_t)b * Skv + kj] : 0;
  const int ks = (kok && sh.use_seg) ? kseg[(size_t)b * Skv + kj] : 0;
  if (tid < qrows) {
    qp_s[tid] = qpos[(size_t)b * Sq + q0 + tid];
    qs_s[tid] = sh.use_seg ? qseg[(size_t)b * Sq + q0 + tid] : 0;
  }
  __syncthreads();
  int any = 0, all = kok && qrows == kTile;
  for (int i = i0; i < i0 + kTile / 2; ++i) {
    bool live = kok && i < qrows;
    if (sh.causal) live = live && qp_s[i] >= kp;
    if (sh.use_seg) live = live && qs_s[i] == ks;
    any |= live;
    all &= live;
  }
  any = __syncthreads_or(any);
  all = __syncthreads_and(all);
  if (tid == 0) {
    const uint8_t m = (uint8_t)((any ? 1 : 0) | (all ? 2 : 0));
    by_q[((size_t)b * nqt + qt) * nkt + kt] = m;
    by_k[((size_t)b * nkt + kt) * nqt + qt] = m;
  }
}

// Rows [row0, row0 + 64) of src[B, S, heads, D] for one head, 16-byte
// cp.async into a swizzled tile; rows at or past S are zero-filled.
__device__ __forceinline__ void stage_rows(uint8_t* tile,
                                           const __nv_bfloat16* src, int b,
                                           int row0, int S, int heads,
                                           int head, int D) {
  const int nch = D >> 3;
  // thread t copies chunks t, t + 128, ...: (row, c) advances by a fixed
  // step, so one division serves the whole tile
  const int drow = kWgThreads / nch, dc = kWgThreads - drow * nch;
  int row = threadIdx.x / nch, c = threadIdx.x - row * nch;
  while (row < kTile) {
    const int gr = row0 + row;
    const bool ok = gr < S;
    const __nv_bfloat16* p =
        src + (((size_t)b * S + (ok ? gr : 0)) * heads + head) * D + c * 8;
    cp_async16(tile + sw128_offset(row, c, kTile), p, ok ? 16 : 0);
    row += drow;
    c += dc;
    if (c >= nch) {
      c -= nch;
      ++row;
    }
  }
}

// Zeroes the columns [D, DP) of the six tiles once: cp.async never writes
// them, so padded Q / K / dO / V columns add 0 to every product.
template <int DP>
__device__ __forceinline__ void zero_padding(uint8_t* sm, int D) {
  constexpr int kChunks = DP / 8;
  const int nch = D >> 3, npad = kChunks - nch;
  for (int e = threadIdx.x; e < 6 * kTile * npad; e += kWgThreads) {
    const int t = e / (kTile * npad), rem = e - t * kTile * npad;
    const int row = rem / npad, c = nch + rem % npad;
    *reinterpret_cast<uint4*>(sm + t * WgSmem<DP>::kTileBytes +
                              sw128_offset(row, c, kTile)) =
        make_uint4(0u, 0u, 0u, 0u);
  }
}

// S (+)= A B^T over DP / 16 k16 steps, both tiles K-major (rows the
// product's rows / columns, d contiguous).
template <int DP>
__device__ __forceinline__ void wgmma_rows_dot(float (&d)[32],
                                               const uint8_t* a,
                                               const uint8_t* b) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const int off = (kk >> 2) * kTile * 128 + (kk & 3) * 32;
    wgmma_ss_m64n64k16(d, sw128_desc(a + off, 16, 1024),
                       sw128_desc(b + off, 16, 1024), kk > 0);
  }
}

// acc[64 x DP] += A[64 x 64] B[64 x DP]: A the four k16 register
// fragments, B a staged tile read [k][d], i.e. MN-major.
template <int DP>
__device__ __forceinline__ void wgmma_acc_rows(float (&acc)[DP / 2],
                                               const uint32_t (&a)[4][4],
                                               const uint8_t* b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t db = sw128_desc(b + kk * 16 * 128, kTile * 128, 1024);
    if constexpr (DP == 128) {
      wgmma_rs_m64n128k16(acc, a[kk], db);
    } else {
      wgmma_rs_m64n64k16(acc, a[kk], db);
    }
  }
}

// Keeps register A fragments live (and in place) until the wgmma that
// reads them asynchronously has been waited for.
__device__ __forceinline__ void fence_a(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(a[kk][r])::"memory");
}

// An accumulator fragment of a 64 x 64 product, rounded to bf16, as the
// A operand of the next product's four k16 steps (the fragment's columns
// become its k).
__device__ __forceinline__ void to_a_operand(const float (&x)[32],
                                             uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[kk][r] = pack_bf16(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1]);
}

// 2^x (ex2.approx, flush to zero: a P below 2^-126 adds nothing a limit
// can see).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// P = exp(cap(scale x) - lse) of one fragment element from its raw score
// x = q.k, with lse2 = lse log2 e (+inf for a row with no live key: P =
// 0), and into pcs the factor P cap' scale that dS = P (dP - Delta) cap'
// scale takes, cap' = 1 - tanh^2 (1 uncapped).
__device__ __forceinline__ float prob(const BwdShape& sh, float x,
                                      float lse2, float& pcs) {
  float p, capd = 1.f;
  if (sh.soft_cap > 0.f) {
    const float t = tanhf(x * sh.scale / sh.soft_cap);
    p = fast_exp2(fmaf(sh.soft_cap * t, kLog2e, -lse2));
    if (sh.keep_capd) capd = 1.f - t * t;
  } else {
    p = fast_exp2(fmaf(x, sh.scale * kLog2e, -lse2));
  }
  pcs = p * capd * sh.scale;
  return p;
}

// Stores this thread's accumulator fragment (rows r0 / r1, DP columns)
// rounded to bf16 into a swizzled tile, for 16-byte global stores.
template <int DP>
__device__ __forceinline__ void fragment_to_tile(uint8_t* tile,
                                                 const float (&acc)[DP / 2],
                                                 int r0, int r1, int lane) {
#pragma unroll
  for (int c = 0; c < DP / 8; ++c) {
    const uint32_t o = ((lane & 3) << 1) * 2;
    *reinterpret_cast<uint32_t*>(tile + sw128_offset(r0, c, kTile) + o) =
        pack_bf16(acc[4 * c], acc[4 * c + 1]);
    *reinterpret_cast<uint32_t*>(tile + sw128_offset(r1, c, kTile) + o) =
        pack_bf16(acc[4 * c + 2], acc[4 * c + 3]);
  }
}

// Rows [row0, row0 + 64) of a swizzled tile out to dst[B, S, heads, D]
// for one head, 16 bytes a store; rows at or past S are not written.
__device__ __forceinline__ void tile_to_rows(__nv_bfloat16* dst,
                                             const uint8_t* tile, int b,
                                             int row0, int S, int heads,
                                             int head, int D) {
  const int nch = D >> 3;
  for (int e = threadIdx.x; e < kTile * nch; e += kWgThreads) {
    const int row = e / nch, c = e - row * nch;
    if (row0 + row < S) {
      *reinterpret_cast<uint4*>(
          dst + (((size_t)b * S + row0 + row) * heads + head) * D + c * 8) =
          *reinterpret_cast<const uint4*>(tile + sw128_offset(row, c, kTile));
    }
  }
}

// The block's row of the tile map into shared memory (read after a
// barrier).
__device__ __forceinline__ void load_map(uint8_t* dst, const uint8_t* src,
                                         int n) {
  for (int t = threadIdx.x; t < n; t += kWgThreads) dst[t] = src[t];
}

// A fragment's two adjacent columns 8c + 2 (lane % 4) + {0, 1} of a
// per-column array in shared memory.
template <typename T>
__device__ __forceinline__ void cols2(const T* a, int c, int lane, T& x0,
                                      T& x1) {
  const int col = (c << 3) + ((lane & 3) << 1);
  x0 = a[col];
  x1 = a[col + 1];
}

// dQ: one warpgroup per (64-query tile, head, batch row) over the live KV
// tiles.  Q and dO stay staged; K and V move through the 2-stage ring.
// S = Q K^T and dP = dO V^T (SS, both K-major), P on the fragment while
// dP runs, dS rounded to bf16 as the A operand of dQ += dS K (K read
// [key][d], MN-major).
template <int DP>
__global__ void __launch_bounds__(kWgThreads)
flash_bwd_dq_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          const __nv_bfloat16* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          const int* __restrict__ qpos,
                          const int* __restrict__ kpos,
                          const int* __restrict__ qseg,
                          const int* __restrict__ kseg,
                          const uint8_t* __restrict__ map_by_q,
                          __nv_bfloat16* __restrict__ dq, BwdShape sh,
                          int D) {
  using L = WgSmem<DP>;
  constexpr int kTB = L::kTileBytes;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* q_s = sm + L::kFix0;
  uint8_t* do_s = sm + L::kFix1;
  uint8_t* k_s = sm + L::kRing0;
  uint8_t* v_s = sm + L::kRing1;
  int* kpos_s = reinterpret_cast<int*>(sm + L::kMeta);   // [2][64]
  int* kseg_s = kpos_s + 2 * kTile;                       // [2][64]
  uint8_t* map_s = sm + L::kBytes;                        // [nkt]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * kTile;
  const int Sq = sh.Sq, Skv = sh.Skv, H = sh.H, KVH = sh.KVH;
  const int kvh = h / (H / KVH);
  const int nqt = gridDim.x, nkt = (Skv + kTile - 1) / kTile;

  zero_padding<DP>(sm, D);
  stage_rows(q_s, q, b, q0, Sq, H, h, D);
  stage_rows(do_s, dout, b, q0, Sq, H, h, D);
  cp_async_commit();
  load_map(map_s, map_by_q + ((size_t)b * nqt + qt) * nkt, nkt);

  // this thread's two fragment rows, with lse log2 e and Delta (a row
  // past Sq gets lse = +inf: P = 0)
  const int r0 = warp * 16 + (lane >> 2), r1 = r0 + 8;
  const bool ok0 = q0 + r0 < Sq, ok1 = q0 + r1 < Sq;
  const size_t so = (size_t)b * Sq + q0, lo = ((size_t)b * H + h) * Sq + q0;
  const int qp0 = ok0 ? qpos[so + r0] : 0, qp1 = ok1 ? qpos[so + r1] : 0;
  const int qs0 = (sh.use_seg && ok0) ? qseg[so + r0] : 0;
  const int qs1 = (sh.use_seg && ok1) ? qseg[so + r1] : 0;
  const float lse0 = ok0 ? lse[lo + r0] * kLog2e : INFINITY;
  const float lse1 = ok1 ? lse[lo + r1] * kLog2e : INFINITY;
  const float dl0 = ok0 ? delta[lo + r0] : 0.f;
  const float dl1 = ok1 ? delta[lo + r1] : 0.f;
  __syncthreads();   // the map visible

  auto next_live = [&](int j, bool& full) -> int {
    for (; j < nkt; ++j) {
      const uint8_t m = map_s[j];
      if (m & 1) {
        full = (m & 2) != 0;
        return j;
      }
    }
    return j;
  };
  auto stage_kv = [&](int j, int st) {
    stage_rows(k_s + st * kTB, k, b, j * kTile, Skv, KVH, kvh, D);
    stage_rows(v_s + st * kTB, v, b, j * kTile, Skv, KVH, kvh, D);
    const int i = tid & (kTile - 1), kj = j * kTile + i;
    const bool ok = kj < Skv;
    const size_t o = (size_t)b * Skv + (ok ? kj : 0);
    if (tid < kTile) {
      cp_async4(kpos_s + st * kTile + i, kpos + o, ok ? 4 : 0);
    } else if (sh.use_seg) {
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
  int st = 0;

  while (j < nkt) {
    bool full_next = false;
    const int jn = next_live(j + 1, full_next);
    if (jn < nkt) stage_kv(jn, st ^ 1);   // overlaps this tile's compute
    cp_async_commit();
    cp_async_wait<1>();
    fence_proxy_async();
    __syncthreads();

    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
    wgmma_rows_dot<DP>(s, q_s, k_s + st * kTB);
    wgmma_commit();
    wgmma_rows_dot<DP>(dp, do_s, v_s + st * kTB);
    wgmma_commit();
    wgmma_wait<1>();   // S is in; dP may still run
    fence_regs(s);

    // P cap' scale on the fragment while dP runs: s[4c + e] is row r0
    // (e < 2) or r1 (e >= 2), key column 8c + 2 (lane % 4) + (e & 1);
    // a dead pair (only in a tile the map marks partial) gives 0
    const int* kp = kpos_s + st * kTile;
    const int* ks = kseg_s + st * kTile;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      bool live[4] = {true, true, true, true};
      if (!full) {
        int p0, p1, g0 = 0, g1 = 0;
        cols2(kp, c, lane, p0, p1);
        if (sh.use_seg) cols2(ks, c, lane, g0, g1);
        const int col = (c << 3) + ((lane & 3) << 1);
        const bool in0 = j * kTile + col < Skv;
        const bool in1 = j * kTile + col + 1 < Skv;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qp = (e & 2) ? qp1 : qp0, qg = (e & 2) ? qs1 : qs0;
          const int kpe = (e & 1) ? p1 : p0, kge = (e & 1) ? g1 : g0;
          bool l = (e & 1) ? in1 : in0;
          if (sh.causal) l = l && qp >= kpe;
          if (sh.use_seg) l = l && qg == kge;
          live[e] = l;
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * c + e;
        float pcs;
        prob(sh, s[i], (e & 2) ? lse1 : lse0, pcs);
        s[i] = live[e] ? pcs : 0.f;
      }
    }
    wgmma_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int i = 0; i < 32; ++i) dp[i] = s[i] * (dp[i] - ((i & 2) ? dl1 : dl0));

    // dQ += dS K, dS rounded to bf16 in registers
    uint32_t a[4][4];
    to_a_operand(dp, a);
    fence_regs(acc);
    wgmma_fence();
    wgmma_acc_rows<DP>(acc, a, k_s + st * kTB);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    fence_a(a);
    __syncthreads();   // stage st consumed before it is loaded again
    st ^= 1;
    j = jn;
    full = full_next;
  }

  // epilogue: dQ rounded once, through Q's tile for 16-byte stores
  cp_async_wait<0>();
  __syncthreads();
  fragment_to_tile<DP>(q_s, acc, r0, r1, lane);
  __syncthreads();
  tile_to_rows(dq, q_s, b, q0, Sq, H, h, D);
}

// dK/dV: one warpgroup per (64-key tile, KV head, batch row) over the
// group's query heads and, for each, the live query tiles.  K and V stay
// staged; Q, dO, the lse and Delta of each (head, query tile) move through
// the 2-stage ring.  The products are transposed so the keys are the
// accumulator rows: S^T = K Q^T and dP^T = V dO^T (SS, both K-major),
// P^T and dS^T on the fragments (lse and Delta by column), then dV +=
// P^T dO and dK += dS^T Q with P^T and dS^T rounded to bf16 as the A
// operands and dO / Q read [query][d] (MN-major): the same staged tiles
// serve both readings.  dK and dV stay in registers over the whole group.
template <int DP>
__global__ void __launch_bounds__(kWgThreads)
flash_bwd_dkdv_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            const __nv_bfloat16* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            const int* __restrict__ qpos,
                            const int* __restrict__ kpos,
                            const int* __restrict__ qseg,
                            const int* __restrict__ kseg,
                            const uint8_t* __restrict__ map_by_k,
                            __nv_bfloat16* __restrict__ dk,
                            __nv_bfloat16* __restrict__ dv, BwdShape sh,
                            int D) {
  using L = WgSmem<DP>;
  constexpr int kTB = L::kTileBytes;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* k_s = sm + L::kFix0;
  uint8_t* v_s = sm + L::kFix1;
  uint8_t* q_s = sm + L::kRing0;
  uint8_t* do_s = sm + L::kRing1;
  int* qpos_s = reinterpret_cast<int*>(sm + L::kMeta);    // [2][64]
  int* qseg_s = qpos_s + 2 * kTile;                        // [2][64]
  float* lse_s = reinterpret_cast<float*>(qseg_s + 2 * kTile);
  float* dl_s = lse_s + 2 * kTile;                         // [2][64]
  uint8_t* map_s = sm + L::kBytes;                         // [nqt]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int kt = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int k0 = kt * kTile;
  const int Sq = sh.Sq, Skv = sh.Skv, H = sh.H, KVH = sh.KVH;
  const int G = H / KVH, hbase = kvh * G;   // the heads reading kvh
  const int nkt = gridDim.x, nqt = (Sq + kTile - 1) / kTile;

  zero_padding<DP>(sm, D);
  stage_rows(k_s, k, b, k0, Skv, KVH, kvh, D);
  stage_rows(v_s, v, b, k0, Skv, KVH, kvh, D);
  cp_async_commit();
  load_map(map_s, map_by_k + ((size_t)b * nkt + kt) * nqt, nqt);

  // this thread's two fragment rows (keys)
  const int r0 = warp * 16 + (lane >> 2), r1 = r0 + 8;
  const bool ok0 = k0 + r0 < Skv, ok1 = k0 + r1 < Skv;
  const size_t so = (size_t)b * Skv + k0;
  const int kp0 = ok0 ? kpos[so + r0] : 0, kp1 = ok1 ? kpos[so + r1] : 0;
  const int ks0 = (sh.use_seg && ok0) ? kseg[so + r0] : 0;
  const int ks1 = (sh.use_seg && ok1) ? kseg[so + r1] : 0;
  __syncthreads();   // the map visible

  // the next live (head g of the group, query tile qt) at or after (g, qt)
  auto next_live = [&](int& g, int& qt, bool& full) {
    for (; g < G; ++g, qt = 0) {
      for (; qt < nqt; ++qt) {
        const uint8_t m = map_s[qt];
        if (m & 1) {
          full = (m & 2) != 0;
          return;
        }
      }
    }
  };
  auto stage_q = [&](int g, int qt, int st) {
    const int h = hbase + g, q0 = qt * kTile;
    stage_rows(q_s + st * kTB, q, b, q0, Sq, H, h, D);
    stage_rows(do_s + st * kTB, dout, b, q0, Sq, H, h, D);
    const int i = tid & (kTile - 1), qi = q0 + i;
    const bool ok = qi < Sq;
    const size_t po = (size_t)b * Sq + (ok ? qi : 0);
    const size_t lo = ((size_t)b * H + h) * Sq + (ok ? qi : 0);
    if (tid < kTile) {
      cp_async4(qpos_s + st * kTile + i, qpos + po, ok ? 4 : 0);
      cp_async4(lse_s + st * kTile + i, lse + lo, ok ? 4 : 0);
    } else {
      if (sh.use_seg) cp_async4(qseg_s + st * kTile + i, qseg + po, ok ? 4 : 0);
      cp_async4(dl_s + st * kTile + i, delta + lo, ok ? 4 : 0);
    }
  };

  bool full = false;
  int g = 0, qt = 0;
  next_live(g, qt, full);
  if (g < G) stage_q(g, qt, 0);
  cp_async_commit();

  float dka[DP / 2], dva[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dka[i] = dva[i] = 0.f;
  int st = 0;

  while (g < G) {
    bool full_next = false;
    int gn = g, qtn = qt + 1;
    next_live(gn, qtn, full_next);
    if (gn < G) stage_q(gn, qtn, st ^ 1);   // overlaps this tile's compute
    cp_async_commit();
    cp_async_wait<1>();
    fence_proxy_async();
    __syncthreads();

    const uint8_t* qt_s = q_s + st * kTB;
    const uint8_t* dot_s = do_s + st * kTB;
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
    wgmma_rows_dot<DP>(s, k_s, qt_s);      // S^T = K Q^T
    wgmma_commit();
    wgmma_rows_dot<DP>(dp, v_s, dot_s);    // dP^T = V dO^T
    wgmma_commit();
    wgmma_wait<1>();   // S^T is in; dP^T may still run
    fence_regs(s);

    // P^T on the fragment (s[4c + e]: key row r0 (e < 2) or r1, query
    // column 8c + 2 (lane % 4) + (e & 1)), rounded to bf16 as dV's A
    // operand; s keeps P cap' scale for dS^T.  A dead pair (only in a
    // tile the map marks partial) gives 0.
    const int q0 = qt * kTile;
    const int* qp = qpos_s + st * kTile;
    const int* qs = qseg_s + st * kTile;
    const float* lc = lse_s + st * kTile;
    uint32_t ap[4][4];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      float l0, l1;
      cols2(lc, c, lane, l0, l1);
      l0 *= kLog2e;
      l1 *= kLog2e;
      bool live[4] = {true, true, true, true};
      if (!full) {
        int p0, p1, g0 = 0, g1 = 0;
        cols2(qp, c, lane, p0, p1);
        if (sh.use_seg) cols2(qs, c, lane, g0, g1);
        const int col = q0 + (c << 3) + ((lane & 3) << 1);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpe = (e & 2) ? kp1 : kp0, kge = (e & 2) ? ks1 : ks0;
          const int qpe = (e & 1) ? p1 : p0, qge = (e & 1) ? g1 : g0;
          bool l = col + (e & 1) < Sq;
          if (sh.causal) l = l && qpe >= kpe;
          if (sh.use_seg) l = l && qge == kge;
          live[e] = l;
        }
      }
      float pv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * c + e;
        float pcs;
        const float p = prob(sh, s[i], (e & 1) ? l1 : l0, pcs);
        pv[e] = live[e] ? p : 0.f;
        s[i] = live[e] ? pcs : 0.f;
      }
      // fragment elements 4c..4c+3 are A's (kk = c / 2, r = 2 (c % 2) +
      // {0 (row r0), 1 (row r1)}) pairs
      ap[c >> 1][2 * (c & 1)] = pack_bf16(pv[0], pv[1]);
      ap[c >> 1][2 * (c & 1) + 1] = pack_bf16(pv[2], pv[3]);
    }
    fence_regs(dva);
    wgmma_fence();
    wgmma_acc_rows<DP>(dva, ap, dot_s);    // dV += P^T dO, beside dS^T
    wgmma_commit();
    wgmma_wait<1>();   // dP^T is in
    fence_regs(dp);
    const float* dc = dl_s + st * kTile;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      float d0, d1;
      cols2(dc, c, lane, d0, d1);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * c + e;
        dp[i] = s[i] * (dp[i] - ((e & 1) ? d1 : d0));
      }
    }
    uint32_t ads[4][4];
    to_a_operand(dp, ads);
    fence_regs(dka);
    wgmma_fence();
    wgmma_acc_rows<DP>(dka, ads, qt_s);    // dK += dS^T Q
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dva);
    fence_regs(dka);
    fence_a(ap);
    fence_a(ads);
    __syncthreads();   // stage st consumed before it is loaded again
    st ^= 1;
    g = gn;
    qt = qtn;
    full = full_next;
  }

  // epilogue: dK and dV rounded once, through K's and V's tiles
  cp_async_wait<0>();
  __syncthreads();
  fragment_to_tile<DP>(k_s, dka, r0, r1, lane);
  fragment_to_tile<DP>(v_s, dva, r0, r1, lane);
  __syncthreads();
  tile_to_rows(dk, k_s, b, k0, Skv, KVH, kvh, D);
  tile_to_rows(dv, v_s, b, k0, Skv, KVH, kvh, D);
}

template <int DP>
cudaError_t launch_bwd_bf16(const BwdPtrs& a, int B, const BwdShape& sh,
                            int D, cudaStream_t stream, int which,
                            int* info) {
  using T = __nv_bfloat16;
  const int nqt = (sh.Sq + kTile - 1) / kTile;
  const int nkt = (sh.Skv + kTile - 1) / kTile;
  const size_t smem_kv = WgSmem<DP>::kAlloc + (size_t)nqt;
  const size_t smem_q = WgSmem<DP>::kAlloc + (size_t)nkt;
  auto kdkdv = flash_bwd_dkdv_wgmma_kernel<DP>;
  auto kdq = flash_bwd_dq_wgmma_kernel<DP>;
  if (info) {
    return which == 0 ? kernel_info(kdkdv, kWgThreads, smem_kv, info)
                      : kernel_info(kdq, kWgThreads, smem_q, info);
  }
  cudaError_t err = cudaFuncSetAttribute(
      kdkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_kv);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      kdq, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_q);
  if (err != cudaSuccess) return err;
  err = launch_delta<T>(a, B, sh, D, stream);
  if (err != cudaSuccess) return err;
  uint8_t* by_q = a.tile_map;
  uint8_t* by_k = by_q + (size_t)B * nqt * nkt;
  flash_bwd_tile_map_kernel<<<dim3(nkt, nqt, B), kWgThreads, 0, stream>>>(
      a.qpos, a.kpos, a.qseg, a.kseg, by_q, by_k, sh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  kdkdv<<<dim3(nkt, sh.KVH, B), kWgThreads, smem_kv, stream>>>(
      q, k, v, dout, a.lse, a.delta, a.qpos, a.kpos, a.qseg, a.kseg, by_k,
      static_cast<T*>(a.dk), static_cast<T*>(a.dv), sh, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  kdq<<<dim3(nqt, sh.H, B), kWgThreads, smem_q, stream>>>(
      q, k, v, dout, a.lse, a.delta, a.qpos, a.kpos, a.qseg, a.kseg, by_q,
      static_cast<T*>(a.dq), sh, D);
  return cudaGetLastError();
}

cudaError_t dispatch(int D, int dtype, const BwdPtrs& a, int B,
                     const BwdShape& sh, cudaStream_t s, int which,
                     int* info) {
  if (D != 16 && D != 32 && D != 64 && D != 96 && D != 128)
    return cudaErrorInvalidValue;
  if (dtype == 1) {
    return D <= 64 ? launch_bwd_bf16<64>(a, B, sh, D, s, which, info)
                   : launch_bwd_bf16<128>(a, B, sh, D, s, which, info);
  }
  if (dtype != 0) return cudaErrorInvalidValue;
  switch (D) {
    case 16: return launch_bwd_f32<16>(a, B, sh, s, which, info);
    case 32: return launch_bwd_f32<32>(a, B, sh, s, which, info);
    case 64: return launch_bwd_f32<64>(a, B, sh, s, which, info);
    case 96: return launch_bwd_f32<96>(a, B, sh, s, which, info);
    default: return launch_bwd_f32<128>(a, B, sh, s, which, info);
  }
}

}  // namespace
}  // namespace helix

// dtype: 0 = float32, 1 = bfloat16.  q/o/dout/dq [B, Sq, H, D], k/v/dk/dv
// [B, Skv, KVH, D], lse and the delta scratch f32 [B, H, Sq], qpos/qseg
// [B, Sq] and kpos/kseg [B, Skv] int32, all contiguous device memory;
// qseg/kseg may both be null (no segments).  tile_map: bf16, scratch of
// 2 B ceil(Sq / 64) ceil(Skv / 64) bytes (float32: unread, may be null).
// soft_cap <= 0 disables the cap.  drop_cap_derivative: 0 (see the
// header).
extern "C" int helix_flash_attention_backward(
    const void* q, const void* k, const void* v, const void* o,
    const void* lse, const void* dout, const void* qpos, const void* kpos,
    const void* qseg, const void* kseg, void* dq, void* dk, void* dv,
    void* delta, void* tile_map, int B, int Sq, int Skv, int H, int KVH,
    int D, int causal, float scale, float soft_cap, int dtype,
    int drop_cap_derivative, void* stream) {
  if (B <= 0 || Sq <= 0) return cudaSuccess;
  if (Skv <= 0 || KVH <= 0 || H % KVH != 0)
    return cudaErrorInvalidValue;
  helix::BwdPtrs a{q, k, v, o, dout, static_cast<const float*>(lse),
                   static_cast<const int*>(qpos),
                   static_cast<const int*>(kpos),
                   static_cast<const int*>(qseg),
                   static_cast<const int*>(kseg), dq, dk, dv,
                   static_cast<float*>(delta),
                   static_cast<uint8_t*>(tile_map)};
  if (dtype == 1 && tile_map == nullptr) return cudaErrorInvalidValue;
  helix::BwdShape sh{Sq, Skv, H, KVH, scale, soft_cap,
                     causal != 0, qseg != nullptr, drop_cap_derivative == 0};
  return static_cast<int>(helix::dispatch(
      D, dtype, a, B, sh, static_cast<cudaStream_t>(stream), 0,
      nullptr));
}

// Launch resources of the dK/dV kernel (which 0) or the dQ kernel (which
// 1) for head dim D, dtype and sequence length S (the bf16 form's shared
// memory holds a byte per 64-row tile of S): info[4] = shared memory
// per block (bytes), registers per thread, blocks per SM, spill bytes per
// thread.
extern "C" int helix_flash_attention_backward_info(int D, int dtype,
                                                   int which, int S,
                                                   int* info) {
  helix::BwdPtrs a{};
  helix::BwdShape sh{S, S, 1, 1, 1.f, 0.f, true, false, true};
  return static_cast<int>(
      helix::dispatch(D, dtype, a, 1, sh, nullptr, which, info));
}
