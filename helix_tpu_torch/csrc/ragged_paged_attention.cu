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
// the tensor cores would become the limit.  The TPU kernel computes every
// product in f32 (paged_kernel.py:182, 221-233, 250-262), and so does this
// one, on CUDA cores: the f32 work is small next to the bytes.
//
// Design: a split over history pages, then a merge.
//  * Pass 1, one block of 8 warps per (query tile, part, KV head g); the
//    query tiles of all rows are numbered in one axis (a row of q_len n
//    owns ceil(n / tile) of them), so the grid holds no row's padding.
//    A query tile is up to 32 (token, head) rows: 32 / group tokens of the
//    row times the group's H / KVH query heads, so K/V are read once for
//    the group.  Parts 0 .. n_splits-1 cut the history into spans of
//    pages_per_split whole pages (the host picks it from shapes alone); the
//    last part, n_splits, is the row's fresh tokens, causal.  A block whose
//    span starts at or past hist[r] exits at once.  A decode row (q_len 1)
//    owns one tile and a multi-token row (mixed steps, chunks, prefix
//    hits) one per 32 / group tokens; the mapping from tile to row is made
//    on the device from q_len.  The block loads its span's page-table
//    entries into shared memory once and streams 32-token chunks (a page
//    or more; each token's K and V rows are contiguous runs of D elements)
//    through a 3-stage cp.async ring of 16-byte copies, so up to 96 tokens
//    are in flight per block.  Each chunk is staged once for all query
//    rows of the block.  Scores: lane = key, each warp owns every eighth
//    query row, q in shared memory in f32 (broadcast reads); the softmax
//    max and sum are warp shuffles; P goes through a per-warp row of shared
//    memory to the P.V product, where each lane owns 4 of the D outputs.
//    The block writes its partial (m, l, acc[D]) per query row, f32, to
//    scratch.
//  * Pass 2, one block of 8 warps per (query tile, KV head), merges the
//    valid parts of each (token, head) in f32 (a warp per pair, lanes over
//    parts, then over outputs) and rounds the output once; stores stay
//    masked to each row's own [t0, t0 + q_len).
//
// Kept from the first design, deliberately:
//  * blocks run in parallel in no order, so stores are masked to the
//    row's own tokens -- there is no tail spill onto the next row and no
//    padded T;
//  * K/V slots outside the live range stage as 0 (zero-filled copies), so
//    a masked slot can never poison the sum through 0 * NaN (garbage
//    pages, a neighbouring row's NaN fresh V);
//  * the pool holds all L layers; only layer `layer` is read; a page-table
//    index past maxP - 1 reads the last entry (as the first design did).
//
// Int8 pools (the Pallas kernel's quantized=True form, K1-int8): the pool
// holds int8 codes and two float32 scale pools [L, N, P, KVH], one scale
// per (token slot, KV head).  Codes and scales are staged raw (16 codes
// per copy) and dequantized in f32 in registers -- never rounded to the
// query dtype, as the TPU kernel dequantizes in-register
// (paged_kernel.py:219-227): a slot's K scale multiplies its f32 dot with
// q, its V scale its f32 weight.  Fresh K/V stay at the query dtype.  An
// int8 pool moves 2*D + 8 bytes per history token and KV head (264 B at
// D=128) where a bf16 pool moves 4*D (512 B).

// The cold form (tiered KV residency, ROADMAP B4), float32 queries only:
// bf16 tiered calls run the tensor-core form of
// ragged_paged_attention_cold.cu.  The Pallas kernel
// has no tiered entry point: the reference routes tiered calls to its XLA
// oracle (helix_tpu/ops/paged.py:132-186, 255-310).  Here they are more
// parts of the same split-and-merge.  Each row r may carry a demoted span
// [span_lo[r], span_hi[r]) of its history, whose table entries point at
// page 0: history keys inside it are masked and staged as 0, and a
// history part wholly inside it exits.  The span's K/V arrive instead as
// a staged slab of chunks cold_k/cold_v [L, nC, Ct, KVH, D] (int8 codes
// with f32 scales [L, nC, Ct, KVH]); chunk c belongs to row cold_row[c]
// (-1: nobody) and holds cold_len[c] tokens.  Cold part j of a query
// tile (one of n_cold parts, after the fresh part) attends every chunk c
// = j (mod n_cold) that its row owns, no causal mask (cold tokens precede
// every query), folding them into one (m, l, acc); pass 2 merges the
// row's valid history, fresh and cold parts, which it lists in shared
// memory.  Cold K/V dequantize as hot history does.  Bound: bytes again,
// the slab's chunks of the rows in the call read once per KV head.

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace helix {
namespace {

constexpr int kThreads = 256;   // 8 warps: the f32 math is latency bound,
                                // so more warps per SM, fewer rows each
constexpr int kWarps = kThreads / 32;
constexpr int kKeys = 32;       // keys per staged chunk: one per lane
constexpr int kStages = 3;
constexpr int kMaxRows = 32;    // (token, head) query rows per block
constexpr int kRowsPerWarp = kMaxRows / kWarps;

__host__ __device__ constexpr int align16(int x) { return (x + 15) & ~15; }

// Shared-memory plan of pass 1 (bytes; every region 16-byte aligned).
struct K1Smem {
  int q, p, table, ring, stage, kstride, vstride, scales, total;
  __host__ __device__ K1Smem(int rows_cap, int D, int pps, int es,
                             bool quant) {
    q = 0;
    p = q + rows_cap * D * 4;
    table = p + rows_cap * kKeys * 4;
    ring = table + align16(pps * 4);
    kstride = D * es + 16;   // padded: lanes read 16 B of 32 rows
    vstride = D * es;
    scales = kKeys * (kstride + vstride);
    stage = scales + (quant ? 2 * kKeys * 4 : 0);
    total = ring + kStages * stage;
  }
};

__host__ __device__ inline int tile_tokens(int group) {
  return group >= kMaxRows ? 1 : kMaxRows / group;
}

// Query tiles are numbered across rows: row r owns ceil(q_len[r] / qb)
// consecutive tiles.  The grid holds an upper bound known on the host,
// min(T, ceil(T / qb) + R); a tile number past the last tile maps to no
// row.  Returns false there.
__host__ __device__ inline int tiles_bound(int T, int qb, int R) {
  const int b = (T + qb - 1) / qb + R;
  return b < T ? b : T;
}
__device__ __forceinline__ bool find_tile(int ft, const int* q_len, int R,
                                          int qb, int& r, int& qtile) {
  int first = 0;
  for (int i = 0; i < R; ++i) {
    const int n = (q_len[i] + qb - 1) / qb;
    if (ft < first + n) {
      r = i;
      qtile = ft - first;
      return true;
    }
    first += n;
  }
  return false;
}

__device__ __forceinline__ float warp_maxf(float x) {
#pragma unroll
  for (int o = 16; o; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sumf(float x) {
#pragma unroll
  for (int o = 16; o; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// 16 staged bytes -> 16 / sizeof(E) floats.
template <typename E>
__device__ __forceinline__ void piece_to_float(const uint4& raw,
                                               float* out) {
  if constexpr (std::is_same<E, float>::value) {
    out[0] = __uint_as_float(raw.x);
    out[1] = __uint_as_float(raw.y);
    out[2] = __uint_as_float(raw.z);
    out[3] = __uint_as_float(raw.w);
  } else if constexpr (std::is_same<E, __nv_bfloat16>::value) {
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      out[2 * i] = __uint_as_float(w[i] << 16);
      out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  } else {
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        out[4 * i + j] = (float)(int8_t)((w[i] >> (8 * j)) & 0xffu);
    }
  }
}

// 4 staged elements at p -> floats.
template <typename E>
__device__ __forceinline__ void four_to_float(const uint8_t* p, float* out) {
  if constexpr (std::is_same<E, float>::value) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  } else if constexpr (std::is_same<E, __nv_bfloat16>::value) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    out[0] = __uint_as_float(v.x << 16);
    out[1] = __uint_as_float(v.x & 0xffff0000u);
    out[2] = __uint_as_float(v.y << 16);
    out[3] = __uint_as_float(v.y & 0xffff0000u);
  } else {
    const uint32_t v = *reinterpret_cast<const uint32_t*>(p);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      out[j] = (float)(int8_t)((v >> (8 * j)) & 0xffu);
  }
}

// Everything one pass-1 block needs to know about its keys and rows.
struct Span {
  int kbeg, kend;       // key positions [kbeg, kend) of this part
  bool fresh;           // the row's fresh tokens (causal) or history
  int tok0;             // first token of the tile, row-relative
  int rows;             // live (token, head) rows of the tile
  int group;
  int clo, chi;         // demoted keys [clo, chi), masked (cold form)
};

// The cold form's arguments (all device pointers; unused otherwise).
struct Cold {
  const int* span_lo;   // [R]
  const int* span_hi;   // [R]
  const void* k;        // [L, nC, Ct, KVH, D], the pool's element type
  const void* v;
  const float* ks;      // [L, nC, Ct, KVH] (int8 pools)
  const float* vs;
  const int* row;       // [nC] owning row, -1 = none
  const int* len;       // [nC] live tokens of the chunk
  int nC, Ct, n_cold;
};

// Does cold part j of row r own a live chunk?
__device__ __forceinline__ bool cold_part_live(const Cold& cold, int j,
                                               int r) {
  for (int c = j; c < cold.nC; c += cold.n_cold)
    if (cold.row[c] == r && cold.len[c] > 0) return true;
  return false;
}

// Pass-1 attention of the block's query rows over keys [kbeg, kend),
// staged through the ring.  E is the staged element type; `row_of(pos)`
// gives the K row of key position pos (V is the same offset in its pool),
// `scale_of(pos)` its scale-pool index (int8 pools only).
template <int D, typename E, bool kQuant, bool kSpan, typename RowOf,
          typename ScaleOf>
__device__ __forceinline__ void attend(
    uint8_t* sm, const K1Smem& L, const Span& sp, const E* kbase,
    const E* vbase, const float* kscale, const float* vscale, RowOf row_of,
    ScaleOf scale_of, float sl2, float (&m)[kRowsPerWarp],
    float (&l)[kRowsPerWarp], float (&acc)[kRowsPerWarp][4]) {
  constexpr int kPieces = D * (int)sizeof(E) / 16;   // 16-byte copies / row
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const float* q_s = reinterpret_cast<const float*>(sm + L.q);
  float* p_s = reinterpret_cast<float*>(sm + L.p);
  const int nchunks = (sp.kend - sp.kbeg + kKeys - 1) / kKeys;
  const int nr = sp.rows > warp ? (sp.rows - warp + kWarps - 1) / kWarps : 0;

  auto stage_chunk = [&](int c) {
    if (c >= nchunks) return;
    uint8_t* st = sm + L.ring + (c % kStages) * L.stage;
    const int key0 = sp.kbeg + c * kKeys;
    for (int e = tid; e < 2 * kKeys * kPieces; e += kThreads) {
      const int which = e / (kKeys * kPieces);   // 0 = K, 1 = V
      const int rem = e - which * kKeys * kPieces;
      const int j = rem / kPieces, pc = rem - j * kPieces;
      const int pos = key0 + j;
      bool ok = pos < sp.kend;
      if constexpr (kSpan) ok = ok && (pos < sp.clo || pos >= sp.chi);
      const size_t row = ok ? row_of(pos) : 0;
      const E* src = (which ? vbase : kbase) + row * D + pc * (16 / sizeof(E));
      uint8_t* dst = st + (which ? kKeys * L.kstride + j * L.vstride
                                 : j * L.kstride) + pc * 16;
      cp_async16(dst, src, ok ? 16 : 0);
    }
    if constexpr (kQuant) {
      if (tid < 2 * kKeys) {
        const int j = tid & (kKeys - 1);
        const int pos = key0 + j;
        bool ok = pos < sp.kend;
        if constexpr (kSpan) ok = ok && (pos < sp.clo || pos >= sp.chi);
        const size_t si = ok ? scale_of(pos) : 0;
        cp_async4(st + L.scales + tid * 4, (tid < kKeys ? kscale : vscale) + si,
                  ok ? 4 : 0);
      }
    }
  };

#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) {
    stage_chunk(c);
    cp_async_commit();
  }
  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait<kStages - 2>();
    __syncthreads();   // chunk c landed; chunk c - 1's stage is free
    stage_chunk(c + kStages - 1);
    cp_async_commit();
    const uint8_t* st = sm + L.ring + (c % kStages) * L.stage;
    const int key = sp.kbeg + c * kKeys + lane;   // this lane's key
    const float ks = kQuant ? reinterpret_cast<const float*>(
                                  st + L.scales)[lane] : 1.f;
    const float vs = kQuant ? reinterpret_cast<const float*>(
                                  st + L.scales)[kKeys + lane] : 1.f;

    // scores: lane = key, rows warp, warp + kWarps, ...
    float sc[kRowsPerWarp];
#pragma unroll
    for (int k = 0; k < kRowsPerWarp; ++k) sc[k] = 0.f;
    const uint8_t* krow = st + lane * L.kstride;
#pragma unroll 2
    for (int pc = 0; pc < kPieces; ++pc) {
      constexpr int kVE = 16 / sizeof(E);
      float kv[kVE];
      piece_to_float<E>(*reinterpret_cast<const uint4*>(krow + pc * 16), kv);
#pragma unroll
      for (int k = 0; k < kRowsPerWarp; ++k) {
        if (k < nr) {
          const float* qq = q_s + (warp + kWarps * k) * D + pc * kVE;
#pragma unroll
          for (int e = 0; e < kVE; e += 4) {
            const float4 q4 = *reinterpret_cast<const float4*>(qq + e);
            sc[k] += q4.x * kv[e] + q4.y * kv[e + 1] + q4.z * kv[e + 2] +
                     q4.w * kv[e + 3];
          }
        }
      }
    }
    // online softmax per row, in the log2 domain (scale * log2 e folded)
#pragma unroll
    for (int k = 0; k < kRowsPerWarp; ++k) {
      if (k < nr) {
        const int i = warp + kWarps * k;
        bool ok = key < sp.kend;
        if constexpr (kSpan) ok = ok && (key < sp.clo || key >= sp.chi);
        if (sp.fresh) ok = ok && key <= sp.tok0 + i / sp.group;
        const float x = ok ? sc[k] * ks * sl2 : kMaskValue;
        const float mn = fmaxf(m[k], warp_maxf(x));
        const float alpha = exp2f(m[k] - mn);   // 0 while m is -inf
        const float p = exp2f(x - mn);
        l[k] = l[k] * alpha + warp_sumf(p);
        m[k] = mn;
        p_s[i * kKeys + lane] = p * vs;
#pragma unroll
        for (int d = 0; d < 4; ++d) acc[k][d] *= alpha;
      }
    }
    __syncwarp();
    // acc += P V: lane owns outputs [4 lane, 4 lane + 4)
    if (4 * lane < D) {
      const uint8_t* vst = st + kKeys * L.kstride + lane * 4 * sizeof(E);
#pragma unroll 2
      for (int j = 0; j < kKeys; j += 4) {
        float vv[4][4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          four_to_float<E>(vst + (j + jj) * L.vstride, vv[jj]);
#pragma unroll
        for (int k = 0; k < kRowsPerWarp; ++k) {
          if (k < nr) {
            const float4 p4 = *reinterpret_cast<const float4*>(
                p_s + (warp + kWarps * k) * kKeys + j);
            const float pj[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
              for (int d = 0; d < 4; ++d) acc[k][d] += pj[jj] * vv[jj][d];
            }
          }
        }
      }
    }
    __syncwarp();
  }
  cp_async_wait<0>();
}

// Pass 1.  T: query / fresh K/V type; TP: pool element type (T, or int8_t
// with the scale pools).  grid (tiles_bound * parts, KVH); the cold form
// (kCold) has cold.n_cold more parts.
template <typename T, typename TP, int D, bool kCold>
__global__ void __launch_bounds__(kThreads)
ragged_split_kernel(const T* __restrict__ q, const T* __restrict__ k_new,
                    const T* __restrict__ v_new, const TP* __restrict__ k_pages,
                    const TP* __restrict__ v_pages,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int* __restrict__ t0, const int* __restrict__ q_len,
                    const int* __restrict__ hist,
                    const int* __restrict__ tables,
                    float* __restrict__ part_ml, float* __restrict__ part_acc,
                    int T_tokens, int H, int KVH, int N, int P, int R,
                    int maxP, int layer, int pps, int n_splits,
                    float scale, const Cold cold) {
  constexpr bool kQuant = std::is_same<TP, int8_t>::value;
  constexpr int kEs = sizeof(T) > sizeof(TP) ? sizeof(T) : sizeof(TP);
  const int parts = n_splits + 1 + (kCold ? cold.n_cold : 0);
  const int part = blockIdx.x % parts;
  const int g = blockIdx.y;
  const int group = H / KVH;
  const int qb = tile_tokens(group);
  int r, qtile;
  if (!find_tile(blockIdx.x / parts, q_len, R, qb, r, qtile)) return;
  const int ql = q_len[r];
  const int tok0 = qtile * qb;
  const int hr = hist[r];
  const int span = pps * P;
  const bool fresh = part == n_splits;
  const bool cold_part = kCold && part > n_splits;
  int clo = 0, chi = 0;
  if constexpr (kCold) {
    clo = cold.span_lo[r];
    chi = cold.span_hi[r];
    if (cold_part && !cold_part_live(cold, part - n_splits - 1, r)) return;
    if (!fresh && !cold_part) {
      const int kb = part * span;
      const int ke = part == n_splits - 1 ? hr : min(hr, kb + span);
      if (kb < hr && kb >= clo && ke <= chi) return;   // wholly demoted
    }
  }
  if (!fresh && !cold_part && part * span >= hr) return;   // past the history
  const int ntok = min(qb, ql - tok0);
  const int base = t0[r];

  extern __shared__ __align__(16) uint8_t sm[];
  const K1Smem L(qb * group, D, pps, kEs, kQuant);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  Span sp;
  sp.fresh = fresh;
  sp.tok0 = tok0;
  sp.rows = ntok * group;
  sp.group = group;
  sp.clo = clo;
  sp.chi = chi;
  if (fresh || cold_part) {
    sp.kbeg = 0;
    sp.kend = tok0 + ntok;   // the tile's last token sees keys up to itself
  } else {
    sp.kbeg = part * span;
    sp.kend = part == n_splits - 1 ? hr : min(hr, (part + 1) * span);
  }

  // q rows of the tile (row i: token tok0 + i / group, head g*group + i %
  // group), f32; the span's page-table entries
  float* q_s = reinterpret_cast<float*>(sm + L.q);
  {
    // 16 bytes per load: a token's group rows are contiguous in q
    constexpr int kVE = 16 / sizeof(T);
    const int per_tok = group * D / kVE;
#pragma unroll 4
    for (int e = tid; e < ntok * per_tok; e += kThreads) {
      const int tk = e / per_tok, w = e - tk * per_tok;
      const uint4 raw = *reinterpret_cast<const uint4*>(
          q + ((size_t)(base + tok0 + tk) * H + g * group) * D + w * kVE);
      float* dst = q_s + (size_t)e * kVE;
      piece_to_float<T>(raw, dst);
    }
  }
  int* table_s = reinterpret_cast<int*>(sm + L.table);
  const int page0 = part * pps;
  if (!fresh && !cold_part) {
    const int npg = min(pps, maxP - page0);
    for (int i = tid; i < npg; i += kThreads)
      table_s[i] = min(max(tables[(size_t)r * maxP + page0 + i], 0), N - 1);
  }
  __syncthreads();

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][4];
#pragma unroll
  for (int k = 0; k < kRowsPerWarp; ++k) {
    m[k] = -INFINITY;
    l[k] = 0.f;
#pragma unroll
    for (int d = 0; d < 4; ++d) acc[k][d] = 0.f;
  }
  const float sl2 = scale * kLog2e;
  if (fresh) {
    auto row_of = [=](int pos) { return (size_t)(base + pos) * KVH + g; };
    attend<D, T, false, false>(sm, L, sp, k_new, v_new, nullptr, nullptr,
                               row_of, row_of, sl2, m, l, acc);
  } else if (cold_part) {
    // every live chunk of this row that falls to part j, in order
    for (int c = part - n_splits - 1; c < cold.nC; c += cold.n_cold) {
      if (cold.row[c] != r || cold.len[c] <= 0) continue;
      Span sc = sp;
      sc.kend = min(cold.len[c], cold.Ct);
      const size_t row0 = ((size_t)layer * cold.nC + c) * cold.Ct;
      auto row_of = [=](int pos) { return (row0 + pos) * KVH + g; };
      __syncthreads();   // the previous chunk's ring is read out
      attend<D, TP, kQuant, false>(
          sm, L, sc, static_cast<const TP*>(cold.k),
          static_cast<const TP*>(cold.v), cold.ks, cold.vs, row_of, row_of,
          sl2, m, l, acc);
    }
  } else {
    const size_t slot0 = (size_t)layer * N * P;   // first slot of the layer
    auto slot_of = [=](int pos) {
      const int idx = min(pos / P, maxP - 1) - page0;
      return (slot0 + (size_t)table_s[idx] * P + pos % P) * KVH + g;
    };
    attend<D, TP, kQuant, kCold>(sm, L, sp, k_pages, v_pages, k_scale,
                                 v_scale, slot_of, slot_of, sl2, m, l, acc);
  }

  // partial (m, l, acc) per query row
#pragma unroll
  for (int k = 0; k < kRowsPerWarp; ++k) {
    const int i = warp + kWarps * k;
    if (i < sp.rows) {
      const size_t t = base + tok0 + i / group;
      const size_t idx = ((size_t)part * T_tokens + t) * H + g * group +
                         i % group;
      if (lane == 0) {
        part_ml[2 * idx] = m[k];
        part_ml[2 * idx + 1] = l[k];
      }
      if (4 * lane < D) {
        *reinterpret_cast<float4*>(part_acc + idx * D + 4 * lane) =
            make_float4(acc[k][0], acc[k][1], acc[k][2], acc[k][3]);
      }
    }
  }
}

// Pass 2: merge the valid parts of every (token, head) of a tile, round
// once.  grid (tiles_bound, KVH): one block per (query tile, KV head g),
// a warp per (token, head) of the group; lanes first take one part each
// (max and weights), then 4 outputs each.
constexpr int kMergeThreads = 256;

// The cold form lists the valid parts of its row in shared memory
// (flags, then the list), 2 * (n_splits + 1 + n_cold) ints.
template <typename T, int D, bool kCold>
__global__ void __launch_bounds__(kMergeThreads)
ragged_merge_kernel(const float* __restrict__ part_ml,
                    const float* __restrict__ part_acc,
                    const int* __restrict__ t0, const int* __restrict__ q_len,
                    const int* __restrict__ hist, T* __restrict__ out,
                    int T_tokens, int H, int KVH, int R, int span,
                    int n_splits, const Cold cold) {
  const int group = H / KVH;
  const int qb = tile_tokens(group);
  int r, qtile;
  if (!find_tile(blockIdx.x, q_len, R, qb, r, qtile)) return;
  const int g = blockIdx.y;
  const int tok0 = qtile * qb;
  const int ntok = min(qb, q_len[r] - tok0);
  const int base = t0[r], hr = hist[r];
  // valid parts: the history spans that start below hist, then the fresh
  // part (index n_splits), which every token has
  extern __shared__ int merge_sm[];
  int nh = 0;
  int np;
  const int* plist = nullptr;
  if constexpr (kCold) {
    const int total = n_splits + 1 + cold.n_cold;
    int* flags = merge_sm;
    int* list = merge_sm + total;
    int* s_np = list + total;
    const int clo = cold.span_lo[r], chi = cold.span_hi[r];
    for (int p = threadIdx.x; p < total; p += kMergeThreads) {
      bool ok;
      if (p < n_splits) {
        const int kb = p * span;
        const int ke = p == n_splits - 1 ? hr : min(hr, kb + span);
        ok = kb < hr && !(kb >= clo && ke <= chi);
      } else if (p == n_splits) {
        ok = true;
      } else {
        ok = cold_part_live(cold, p - n_splits - 1, r);
      }
      flags[p] = ok;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      int n = 0;
      for (int p = 0; p < total; ++p)
        if (flags[p]) list[n++] = p;
      *s_np = n;
    }
    __syncthreads();
    np = *s_np;
    plist = list;
  } else {
    while (nh < n_splits && nh * span < hr) ++nh;
    np = nh + 1;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int pair = warp; pair < ntok * group; pair += kMergeThreads / 32) {
    const size_t t = base + tok0 + pair / group;
    const int hh = g * group + pair % group;
    auto at = [&](int p) {
      if constexpr (kCold)
        return ((size_t)plist[p] * T_tokens + t) * H + hh;
      else
        return ((size_t)(p < nh ? p : n_splits) * T_tokens + t) * H + hh;
    };
    float mx = -INFINITY;
    for (int p = lane; p < np; p += 32) mx = fmaxf(mx, part_ml[2 * at(p)]);
    mx = warp_maxf(mx);
    float lsum = 0.f, o[4] = {0.f, 0.f, 0.f, 0.f};
    for (int p0 = 0; p0 < np; p0 += 32) {
      float w = 0.f;
      if (p0 + lane < np) {
        const size_t i = at(p0 + lane);
        w = exp2f(part_ml[2 * i] - mx);
        lsum += part_ml[2 * i + 1] * w;
      }
      const int n = min(32, np - p0);
#pragma unroll 4
      for (int p = 0; p < n; ++p) {
        const float wp = __shfl_sync(0xffffffffu, w, p);
        if (4 * lane < D) {
          const float4 a = *reinterpret_cast<const float4*>(
              part_acc + at(p0 + p) * D + 4 * lane);
          o[0] += a.x * wp; o[1] += a.y * wp; o[2] += a.z * wp;
          o[3] += a.w * wp;
        }
      }
    }
    lsum = warp_sumf(lsum);
    if (4 * lane < D) {
      const float inv = 1.f / (lsum > 0.f ? lsum : 1.f);
      T* dst = out + (t * H + hh) * D + 4 * lane;
#pragma unroll
      for (int d = 0; d < 4; ++d) dst[d] = from_float<T>(o[d] * inv);
    }
  }
}

template <typename T, typename TP, int D, bool kCold>
cudaError_t launch(const void* q, const void* k_new, const void* v_new,
                   const void* k_pages, const void* v_pages,
                   const float* k_scale, const float* v_scale, const int* t0,
                   const int* q_len, const int* hist, const int* tables,
                   void* out, float* part_ml, float* part_acc, int T_tokens,
                   int H, int KVH, int N, int P, int R, int maxP, int layer,
                   int pps, int n_splits, float scale, cudaStream_t stream,
                   int* info, const Cold& cold) {
  constexpr bool kQuant = std::is_same<TP, int8_t>::value;
  constexpr int kEs = sizeof(T) > sizeof(TP) ? sizeof(T) : sizeof(TP);
  const int group = H / KVH;
  if (group > kMaxRows || pps <= 0 || n_splits <= 0)
    return cudaErrorInvalidValue;
  if (kCold && (cold.nC <= 0 || cold.Ct <= 0 || cold.n_cold <= 0))
    return cudaErrorInvalidValue;
  const int qb = tile_tokens(group);
  const K1Smem L(qb * group, D, pps, kEs, kQuant);
  auto kern = ragged_split_kernel<T, TP, D, kCold>;
  if (info) return kernel_info(kern, kThreads, L.total, info);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
  if (err != cudaSuccess) return err;
  const int tiles = tiles_bound(T_tokens, qb, R);
  const int parts = n_splits + 1 + (kCold ? cold.n_cold : 0);
  const dim3 grid(tiles * parts, KVH);
  kern<<<grid, kThreads, L.total, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_new),
      static_cast<const T*>(v_new), static_cast<const TP*>(k_pages),
      static_cast<const TP*>(v_pages), k_scale, v_scale, t0, q_len, hist,
      tables, part_ml, part_acc, T_tokens, H, KVH, N, P, R, maxP, layer,
      pps, n_splits, scale, cold);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t merge_smem = kCold ? sizeof(int) * (2 * parts + 1) : 0;
  ragged_merge_kernel<T, D, kCold>
      <<<dim3(tiles, KVH), kMergeThreads, merge_smem, stream>>>(
          part_ml, part_acc, t0, q_len, hist, static_cast<T*>(out),
          T_tokens, H, KVH, R, pps * P, n_splits, cold);
  return cudaGetLastError();
}

template <typename T, typename TP, bool kCold>
cudaError_t dispatch_d(int D, const void* q, const void* k_new,
                       const void* v_new, const void* k_pages,
                       const void* v_pages, const float* k_scale,
                       const float* v_scale, const int* t0, const int* q_len,
                       const int* hist, const int* tables, void* out,
                       float* part_ml, float* part_acc, int n_tokens, int H,
                       int KVH, int N, int P, int R, int maxP, int layer,
                       int pps, int n_splits, float scale, cudaStream_t s,
                       int* info, const Cold& cold) {
#define HELIX_K1_CASE(DIM)                                                  \
  case DIM:                                                                 \
    return launch<T, TP, DIM, kCold>(                                       \
        q, k_new, v_new, k_pages, v_pages, k_scale, v_scale, t0, q_len,     \
        hist, tables, out, part_ml, part_acc, n_tokens, H, KVH, N, P, R,    \
        maxP, layer, pps, n_splits, scale, s, info, cold);
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

template <typename TP, bool kCold = false>
cudaError_t dispatch(int dtype, int D, const void* q, const void* k_new,
                     const void* v_new, const void* k_pages,
                     const void* v_pages, const float* k_scale,
                     const float* v_scale, const int* t0, const int* q_len,
                     const int* hist, const int* tables, void* out,
                     float* part_ml, float* part_acc, int T, int H, int KVH,
                     int N, int P, int R, int maxP, int layer, int pps,
                     int n_splits, float scale, cudaStream_t s, int* info,
                     const Cold& cold = Cold{}) {
  if (H % KVH != 0) return cudaErrorInvalidValue;
  if (dtype == 0) {
    using TPf = typename std::conditional<std::is_same<TP, int8_t>::value,
                                          int8_t, float>::type;
    return dispatch_d<float, TPf, kCold>(
        D, q, k_new, v_new, k_pages, v_pages, k_scale, v_scale, t0, q_len,
        hist, tables, out, part_ml, part_acc, T, H, KVH, N, P, R, maxP,
        layer, pps, n_splits, scale, s, info, cold);
  }
  // bf16 cold calls run ragged_paged_attention_cold.cu's tensor-core form
  if constexpr (!kCold) {
    if (dtype == 1) {
      using TPb = typename std::conditional<std::is_same<TP, int8_t>::value,
                                            int8_t, __nv_bfloat16>::type;
      return dispatch_d<__nv_bfloat16, TPb, kCold>(
          D, q, k_new, v_new, k_pages, v_pages, k_scale, v_scale, t0, q_len,
          hist, tables, out, part_ml, part_acc, T, H, KVH, N, P, R, maxP,
          layer, pps, n_splits, scale, s, info, cold);
    }
  }
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace helix

// dtype: 0 = float32, 1 = bfloat16.  Every pointer is a device pointer;
// q/out are [T, H, D], k_new/v_new [T, KVH, D], pools [L, N, P, KVH, D] of
// the same dtype, t0/q_len/hist [R] int32, tables [R, maxP] int32, all
// contiguous.  The history splits into n_splits spans of pages_per_split
// pages; part_ml [n_splits + 1, T, H, 2] and part_acc [n_splits + 1, T, H,
// D] are float32 scratch for the partial results.
extern "C" int helix_ragged_paged_attention(
    const void* q, const void* k_new, const void* v_new, const void* k_pages,
    const void* v_pages, const void* t0, const void* q_len, const void* hist,
    const void* tables, void* out, void* part_ml, void* part_acc, int T,
    int H, int KVH, int D, int N, int P, int R, int maxP, int layer,
    int pages_per_split, int n_splits, float scale, int dtype,
    void* stream) {
  if (T <= 0 || R <= 0) return cudaSuccess;
  return static_cast<int>(helix::dispatch<void>(
      dtype, D, q, k_new, v_new, k_pages, v_pages, nullptr, nullptr,
      static_cast<const int*>(t0), static_cast<const int*>(q_len),
      static_cast<const int*>(hist), static_cast<const int*>(tables), out,
      static_cast<float*>(part_ml), static_cast<float*>(part_acc), T, H, KVH,
      N, P, R, maxP, layer, pages_per_split, n_splits, scale,
      static_cast<cudaStream_t>(stream), nullptr));
}

// The int8-pool form: as above with int8 pools [L, N, P, KVH, D] and their
// float32 scale pools k_scale/v_scale [L, N, P, KVH]; dtype names the
// query / fresh K/V / output type.
extern "C" int helix_ragged_paged_attention_int8(
    const void* q, const void* k_new, const void* v_new, const void* k_pages,
    const void* v_pages, const void* k_scale, const void* v_scale,
    const void* t0, const void* q_len, const void* hist, const void* tables,
    void* out, void* part_ml, void* part_acc, int T, int H, int KVH, int D,
    int N, int P, int R, int maxP, int layer, int pages_per_split,
    int n_splits, float scale, int dtype, void* stream) {
  if (T <= 0 || R <= 0) return cudaSuccess;
  return static_cast<int>(helix::dispatch<int8_t>(
      dtype, D, q, k_new, v_new, k_pages, v_pages,
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
      static_cast<const int*>(t0), static_cast<const int*>(q_len),
      static_cast<const int*>(hist), static_cast<const int*>(tables), out,
      static_cast<float*>(part_ml), static_cast<float*>(part_acc), T, H, KVH,
      N, P, R, maxP, layer, pages_per_split, n_splits, scale,
      static_cast<cudaStream_t>(stream), nullptr));
}

// Launch resources of pass 1 (the split kernel) at these shapes: info[4] =
// shared memory per block (bytes), registers per thread, blocks per SM,
// spill bytes per thread.  cold: of the cold form's split kernel.
extern "C" int helix_ragged_paged_attention_info(int T, int H, int KVH,
                                                 int D, int pages_per_split,
                                                 int dtype, int quantized,
                                                 int cold, int* info) {
  if (cold) {
    const helix::Cold c{nullptr, nullptr, nullptr, nullptr, nullptr,
                        nullptr, nullptr, nullptr, 1, 1, 1};
    if (quantized)
      return static_cast<int>(helix::dispatch<int8_t, true>(
          dtype, D, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
          nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
          nullptr, T, H, KVH, 1, 1, 1, 1, 0, pages_per_split, 1, 1.f,
          nullptr, info, c));
    return static_cast<int>(helix::dispatch<void, true>(
        dtype, D, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
        nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
        nullptr, T, H, KVH, 1, 1, 1, 1, 0, pages_per_split, 1, 1.f,
        nullptr, info, c));
  }
  if (quantized)
    return static_cast<int>(helix::dispatch<int8_t>(
        dtype, D, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
        nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
        nullptr, T, H, KVH, 1, 1, 1, 1, 0, pages_per_split, 1, 1.f, nullptr,
        info));
  return static_cast<int>(helix::dispatch<void>(
      dtype, D, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
      nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, T, H,
      KVH, 1, 1, 1, 1, 0, pages_per_split, 1, 1.f, nullptr, info));
}

// The cold form (tiered rows): the arguments of helix_ragged_paged_attention
// plus span_lo/span_hi [R] int32, the staged slab cold_k/cold_v [L, nC,
// Ct, KVH, D] of the pool's dtype, cold_row/cold_len [nC] int32, and
// n_cold cold parts; part_ml/part_acc hold n_splits + 1 + n_cold parts.
// dtype 0 only: bf16 tiered calls go to helix_ragged_paged_attention_
// cold_bf16 (ragged_paged_attention_cold.cu).
extern "C" int helix_ragged_paged_attention_cold(
    const void* q, const void* k_new, const void* v_new, const void* k_pages,
    const void* v_pages, const void* t0, const void* q_len, const void* hist,
    const void* tables, const void* span_lo, const void* span_hi,
    const void* cold_k, const void* cold_v, const void* cold_row,
    const void* cold_len, void* out, void* part_ml, void* part_acc, int T,
    int H, int KVH, int D, int N, int P, int R, int maxP, int layer,
    int pages_per_split, int n_splits, int nC, int Ct, int n_cold,
    float scale, int dtype, void* stream) {
  if (T <= 0 || R <= 0) return cudaSuccess;
  const helix::Cold cold{static_cast<const int*>(span_lo),
                         static_cast<const int*>(span_hi), cold_k, cold_v,
                         nullptr, nullptr,
                         static_cast<const int*>(cold_row),
                         static_cast<const int*>(cold_len), nC, Ct, n_cold};
  return static_cast<int>(helix::dispatch<void, true>(
      dtype, D, q, k_new, v_new, k_pages, v_pages, nullptr, nullptr,
      static_cast<const int*>(t0), static_cast<const int*>(q_len),
      static_cast<const int*>(hist), static_cast<const int*>(tables), out,
      static_cast<float*>(part_ml), static_cast<float*>(part_acc), T, H, KVH,
      N, P, R, maxP, layer, pages_per_split, n_splits, scale,
      static_cast<cudaStream_t>(stream), nullptr, cold));
}

// The cold form of the int8 entry point: int8 slab codes with their f32
// scale slabs cold_k_scale/cold_v_scale [L, nC, Ct, KVH].
extern "C" int helix_ragged_paged_attention_int8_cold(
    const void* q, const void* k_new, const void* v_new, const void* k_pages,
    const void* v_pages, const void* k_scale, const void* v_scale,
    const void* t0, const void* q_len, const void* hist, const void* tables,
    const void* span_lo, const void* span_hi, const void* cold_k,
    const void* cold_v, const void* cold_k_scale, const void* cold_v_scale,
    const void* cold_row, const void* cold_len, void* out, void* part_ml,
    void* part_acc, int T, int H, int KVH, int D, int N, int P, int R,
    int maxP, int layer, int pages_per_split, int n_splits, int nC, int Ct,
    int n_cold, float scale, int dtype, void* stream) {
  if (T <= 0 || R <= 0) return cudaSuccess;
  const helix::Cold cold{static_cast<const int*>(span_lo),
                         static_cast<const int*>(span_hi), cold_k, cold_v,
                         static_cast<const float*>(cold_k_scale),
                         static_cast<const float*>(cold_v_scale),
                         static_cast<const int*>(cold_row),
                         static_cast<const int*>(cold_len), nC, Ct, n_cold};
  return static_cast<int>(helix::dispatch<int8_t, true>(
      dtype, D, q, k_new, v_new, k_pages, v_pages,
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
      static_cast<const int*>(t0), static_cast<const int*>(q_len),
      static_cast<const int*>(hist), static_cast<const int*>(tables), out,
      static_cast<float*>(part_ml), static_cast<float*>(part_acc), T, H, KVH,
      N, P, R, maxP, layer, pages_per_split, n_splits, scale,
      static_cast<cudaStream_t>(stream), nullptr, cold));
}
