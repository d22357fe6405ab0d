// K1's cold form (tiered rows) on Hopper's tensor cores (sm_90a): bf16
// queries over bf16 pools, or over int8 pools with their f32 scales.
//
// Replaces no Pallas kernel: the reference sends tiered calls to its XLA
// oracle (helix_tpu/ops/paged.py:132-186, 188-310), and its Pallas kernel
// refuses tiered arguments (helix_tpu/ops/paged_kernel.py:374-379).  The
// contract is that oracle as ops/paged_kernel.py::
// ragged_paged_attention_plain writes it out.  Token t of row r (flat q
// [T, H, D], rows carved by t0/q_len) attends:
//  * its hot history: the keys [0, hist[r]) of pool layer `layer`, read
//    through tables[r], less the demoted span [span_lo[r], span_hi[r]);
//  * its own fresh keys k_new/v_new, causal;
//  * the first cold_len[c] keys of every chunk c of the staged slab
//    cold_k/cold_v [L, nC, Ct, KVH, D] with cold_row[c] == r (no causal
//    mask: cold keys precede every query).
// f32 online softmax, scale given by the caller.  The float32 form stays
// the CUDA-core kernel of ragged_paged_attention.cu: the tensor cores take
// no exact f32 input.
//
// What bounds it on the H100: bytes.  Every history key's K and V are read
// once per KV head (4 D bytes in bf16, 2 D + 8 with int8 codes and their
// scales) for at most 32 (token, head) query rows, far below the ~295
// FLOP/byte where the tensor cores would be the limit.  PR 13's form did
// both products as f32 FMAs on CUDA cores, one key per lane, and passed
// two warp reductions and a __syncthreads per 32 keys: it ran at 8-18% of
// the byte bound.  Here the arithmetic moves to the tensor cores and the
// key stream never drains, so the copies set the pace.
//
// Design:
//  * A pre-pass (cold_worklist_kernel, one block per row) lists each row's
//    live work on the device, with no host sync.  Slot 0 is the row's
//    fresh keys; then its hot ranges [0, lo) and [hi, hist), each cut into
//    equal pieces of at most `span` keys; then its owned live chunks, in
//    ascending index, in parts of span / Ct chunks (more where the row
//    would outgrow its slots).  A row has at most K = ceil(maxP P / span)
//    + 4 items whatever its layout, so every item has a fixed scratch slot
//    and the scratch is K (not n_splits + 1 + n_cold) parts deep.
//  * The main kernel (cold_attend_kernel) runs as many blocks of 4 warps
//    as the card holds at once.  They take units (query tile, item, KV
//    head) from a counter the pre-pass zeroes: the hot and cold units of
//    every row first, the short fresh units last.  No block scans the
//    chunk table or is launched for a part without keys.
//  * A unit streams its keys through a 3-stage cp.async ring of 64 keys:
//    hot keys through the page table, cold keys from the slab, addressed
//    by a window of up to 128 pages or chunks held in shared memory, so
//    nothing drains between the pages or chunks of a unit.  Keys outside
//    the live range (demoted, past cold_len, past the history) are masked
//    and stage as 0, so a masked slot never meets a NaN in garbage pages.
//  * Each warp takes 16 keys of a stage for every query row of the tile
//    (one or two m16 tiles: a tile is up to 32 (token, head) rows, the
//    group's heads of 32 / group tokens): S = Q K^T and O += P V as
//    mma.sync m16n8k16 (bf16 in, f32 accumulate), K by ldmatrix, V by
//    ldmatrix.trans, from tiles whose 16-byte chunks are XOR-swizzled (D 96:
//    rows padded by 16 bytes) so neither read conflicts.  The softmax
//    stays f32 on the accumulator fragment (scale * log2 e folded,
//    DEFAULT_MASK_VALUE for masked keys, causal only in the fresh part).
//    P is split into two bf16 terms, P_hi = bf16(P) and P_lo = bf16(P -
//    P_hi), both taken against the same V fragments: P keeps ~16 bits
//    where one bf16 rounding would break K1's one-ulp limit at 8000-key
//    histories (tests/test_torch_k1_cold.py shows it).
//  * Int8 codes are staged raw and widened to bf16 in shared memory, each
//    warp its own 16 keys of a stage (exact: |code| <= 127).  A key's K scale multiplies its f32 score and its V
//    scale is folded into P: the in-register f32 dequantization of the
//    Pallas kernel and the resident K1-int8, with no rounding to the query
//    type.  Fresh K/V stay bf16.
//  * The 4 warps' states merge in shared memory into the unit's slot
//    (m, l, acc) in f32.  The merge kernel combines a row's slots in list
//    order and rounds once; stores stay masked to the row's own tokens.
//    Nothing is atomic but the work counter, so two launches on the same
//    inputs give the same bits.

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace helix {
namespace {

constexpr int kThreads = 128;      // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kKeys = 64;          // keys per stage, 16 per warp
constexpr int kStages = 3;
constexpr int kMaxRows = 32;       // (token, head) rows of a query tile
constexpr int kWin = 128;          // pages or chunks addressed per window
constexpr int kMeta = kKeys * 12;  // a stage's live flags, K and V scales
constexpr int kPrepThreads = 256;
constexpr int kMergeThreads = 256;

enum : int { kFreshItem = 0, kHotItem = 1, kColdItem = 2 };

__host__ __device__ constexpr int align128(int x) { return (x + 127) & ~127; }

__host__ __device__ inline int tile_tokens(int group) {
  return group >= kMaxRows ? 1 : kMaxRows / group;
}

// As in ragged_paged_attention.cu: query tiles are numbered across rows
// (row r owns ceil(q_len[r] / qb)); the host's bound on their count.
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

// A 64-row tile of bf16 rows of D elements: byte offset of 16-byte chunk
// c of row r.  Chunks are XOR-swizzled by the row so that the 8 rows an
// ldmatrix reads at one chunk fall in 8 distinct bank groups; D 96 (12
// chunks) pads each row by 16 bytes instead.
template <int D>
struct Tile {
  static constexpr int kChunks = D / 8;
  static constexpr int kRow = D == 96 ? 2 * D + 16 : 2 * D;
  __device__ static __forceinline__ int off(int r, int c) {
    if constexpr (D == 96)
      return r * kRow + (c << 4);
    else if constexpr (kChunks >= 8)
      return r * kRow + ((c ^ (r & 7)) << 4);
    else if constexpr (kChunks == 4)
      return r * kRow + ((c ^ ((r >> 1) & 3)) << 4);
    else
      return r * kRow + ((c ^ ((r >> 2) & 1)) << 4);
  }
};

// Shared-memory plan of the main kernel (bytes; regions 128-byte aligned).
// A ring stage holds K then V (bf16 tiles, or int8 codes unpadded) and
// the stage's meta; in the int8 kernel each warp widens its keys of a
// stage into `cbuf`, where the bf16 fresh keys are staged too.  After a unit's last stage the ring
// holds the warps' states while they merge.
struct ColdSmem {
  int q, ring, raw_v, meta, stage, tile, cbuf, cmeta, red_acc, win, rows,
      total;
  __host__ __device__ ColdSmem(int D, bool quant, int R) {
    const int row = D == 96 ? 2 * D + 16 : 2 * D;
    tile = kKeys * row;
    q = 0;
    ring = align128(kMaxRows * row);
    raw_v = quant ? kKeys * D : tile;
    meta = 2 * raw_v;
    stage = align128(meta + kMeta);
    cbuf = ring + kStages * stage;
    cmeta = cbuf + 2 * tile;
    red_acc = kWarps * kMaxRows * 2 * 4;   // after the (m, l) pairs
    const int red = red_acc + kWarps * kMaxRows * (D + 4) * 4;
    const int used = quant ? cmeta + kMeta : cbuf;
    win = align128(used > ring + red ? used : ring + red);
    rows = win + kWin * 16;
    total = rows + (2 * (R + 1) + 1) * 4;
  }
};

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// d[16x8] += a[16x16] b[16x8], bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One warp's online-softmax state over its keys, on the mma fragments:
// m / l of rows (lane / 4) and (lane / 4 + 8) of each m16 tile (l a
// partial sum over this thread's columns until the unit ends), acc the
// O fragment of each m16 x n8 output tile.
template <int D>
struct State {
  float m[2][2], l[2][2];
  float acc[2][D / 8][4];
};

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Attends one staged block of 64 keys: warp w takes keys [16 w, 16 w + 16)
// for the nmt m16 tiles of query rows, one tile after the other (K and V
// fragments are read again for the second: fewer live registers).
// kScaled: int8 keys with per-key K / V scales in the stage's meta.
template <int D, bool kScaled>
__device__ __forceinline__ void attend_stage(
    State<D>& st, const uint8_t* qs, const uint8_t* kt, const uint8_t* vt,
    const uint8_t* meta, int key0, int nmt, bool causal, int tok0,
    int group, float sl2) {
  using TL = Tile<D>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int* live = reinterpret_cast<const int*>(meta);
  const float* ksc = reinterpret_cast<const float*>(meta + kKeys * 4);
  const float* vsc = reinterpret_cast<const float*>(meta + kKeys * 8);
  const int col0 = 16 * warp + 2 * tq;   // this thread's first key column
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    if (mt >= nmt) break;
    // S = Q K^T: K rows are the B operand (n = key, k = d), read K-major
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4], b[4];
      ldsm_x4(b, kt + TL::off(16 * warp + (lane & 7) + ((lane >> 4) << 3),
                              2 * kk + ((lane >> 3) & 1)));
      ldsm_x4(a, qs + TL::off(16 * mt + (lane & 7) +
                                  (((lane >> 3) & 1) << 3),
                              2 * kk + (lane >> 4)));
      mma_bf16(s[0], a, b[0], b[1]);
      mma_bf16(s[1], a, b[2], b[3]);
    }
    // online softmax in the log2 domain, per row (4 threads share a row);
    // P into A fragments as two bf16 terms (a_i: key tile i / 2, row
    // half i % 2)
    uint32_t ph[4], pl[4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int lim = tok0 + (16 * mt + gq + 8 * h) / group;
      float x[2][2];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int kl = col0 + 8 * nt + j;
          const bool use = live[kl] != 0 && (!causal || key0 + kl <= lim);
          x[nt][j] = use ? s[nt][2 * h + j] * (kScaled ? ksc[kl] : 1.f) * sl2
                         : kMaskValue;
        }
      float mx = fmaxf(fmaxf(x[0][0], x[0][1]), fmaxf(x[1][0], x[1][1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float mn = fmaxf(st.m[mt][h], mx);
      const float alpha = fast_exp2(st.m[mt][h] - mn);   // 0 while -inf
      st.m[mt][h] = mn;
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        float p[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          p[j] = fast_exp2(x[nt][j] - mn);
          sum += p[j];
          if (kScaled) p[j] *= vsc[col0 + 8 * nt + j];
        }
        const __nv_bfloat162 hi = __floats2bfloat162_rn(p[0], p[1]);
        ph[2 * nt + h] = *reinterpret_cast<const uint32_t*>(&hi);
        pl[2 * nt + h] = pack_bf16(p[0] - __low2float(hi),
                                   p[1] - __high2float(hi));
      }
      st.l[mt][h] = st.l[mt][h] * alpha + sum;
      // once the row maxima settle, alpha is 1 for the whole warp
      if (__any_sync(0xffffffffu, alpha != 1.f)) {
#pragma unroll
        for (int dt = 0; dt < D / 8; ++dt) {
          st.acc[mt][dt][2 * h] *= alpha;
          st.acc[mt][dt][2 * h + 1] *= alpha;
        }
      }
    }
    // O += P V: V rows are the B operand (k = key, n = d), read through
    // the transposing ldmatrix
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t b[4];
      ldsm_x4_t(b, vt + TL::off(16 * warp + (lane & 7) +
                                    (((lane >> 3) & 1) << 3),
                                2 * dp + (lane >> 4)));
      mma_bf16(st.acc[mt][2 * dp], ph, b[0], b[1]);
      mma_bf16(st.acc[mt][2 * dp], pl, b[0], b[1]);
      mma_bf16(st.acc[mt][2 * dp + 1], ph, b[2], b[3]);
      mma_bf16(st.acc[mt][2 * dp + 1], pl, b[2], b[3]);
    }
  }
}

// Four int8 codes -> four bf16, exactly, packed in pairs.  With a code c
// in a half-word's low byte, the bf16 bits 0x4300 | (c & 0x7f) are 128 +
// (c & 0x7f) and 0x4300 | (c & 0x80) are 128 or 256 (the sign bit): their
// difference is c, exact in bf16 (no I2F, which runs at a quarter of the
// ALU rate).
__device__ __forceinline__ uint32_t widen2(uint32_t x) {
  const uint32_t hi = (x & 0x007f007fu) | 0x43004300u;
  const uint32_t lo = (x & 0x00800080u) | 0x43004300u;
  const __nv_bfloat162 r =
      __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&hi),
              *reinterpret_cast<const __nv_bfloat162*>(&lo));
  return *reinterpret_cast<const uint32_t*>(&r);
}
__device__ __forceinline__ uint2 widen4(uint32_t w) {
  return make_uint2(widen2(__byte_perm(w, 0u, 0x4140)),    // c0, c1
                    widen2(__byte_perm(w, 0u, 0x4342)));   // c2, c3
}

// The 16 keys a warp attends of a staged int8 block, widened to bf16
// tiles by that warp alone (its rows of the tiles are its own).
template <int D>
__device__ __forceinline__ void widen(const uint8_t* raw, uint8_t* out,
                                      const ColdSmem& L) {
  using TL = Tile<D>;
  constexpr int kPieces = D / 16;   // 16 codes a piece
  const int lane = threadIdx.x & 31, j0 = 16 * (threadIdx.x >> 5);
  for (int e = lane; e < 2 * 16 * kPieces; e += 32) {
    const int which = e / (16 * kPieces);
    const int rem = e - which * 16 * kPieces;
    const int j = j0 + rem / kPieces, pc = rem % kPieces;
    const uint4 w = *reinterpret_cast<const uint4*>(
        raw + which * L.raw_v + j * D + pc * 16);
    const uint2 o0 = widen4(w.x), o1 = widen4(w.y), o2 = widen4(w.z),
                o3 = widen4(w.w);
    uint8_t* dst = out + which * L.tile;
    *reinterpret_cast<uint4*>(dst + TL::off(j, 2 * pc)) =
        make_uint4(o0.x, o0.y, o1.x, o1.y);
    *reinterpret_cast<uint4*>(dst + TL::off(j, 2 * pc + 1)) =
        make_uint4(o2.x, o2.y, o3.x, o3.y);
  }
}

// Where a unit's key slot s comes from: fresh keys (row r0 + s KVH, live
// below kend) or a window of pages / chunks (entry s / pg: first pool
// slot, live offsets [lo, hi); a shift where pg is a power of two).
// Returns whether the slot is live.
// Rows are 32-bit: the host checks that every slot row of the pool, the
// slab and the fresh keys fits.
struct KeyAddr {
  const int4* win;   // an entry: first slot, lo, hi
  int r0, pg, shift, kend, KVH, g;
  bool fresh;
  __device__ __forceinline__ bool operator()(int s, uint32_t& row) const {
    if (fresh) {
      row = r0 + s * KVH;
      return s < kend;
    }
    const int i = shift >= 0 ? s >> shift : s / pg, o = s - i * pg;
    const int4 e = win[i];
    row = (uint32_t)(e.x + o) * KVH + g;
    return o >= e.y && o < e.z;
  }
};

// Streams `nslots` key slots through the ring (kRing) and attends each
// stage; without kRing (the int8 kernel's bf16 fresh keys) one stage at a
// time through the bf16 buffer.  EP: the staged element type.
template <int D, typename EP, bool kRing>
__device__ __forceinline__ void stream_keys(
    uint8_t* sm, const ColdSmem& L, State<D>& st, int nslots,
    const KeyAddr& addr, const EP* kb, const EP* vb, const float* ksb,
    const float* vsb, int nmt, bool causal, int tok0, int group,
    float sl2) {
  using TL = Tile<D>;
  constexpr bool kQuant = std::is_same<EP, int8_t>::value;
  constexpr int kVE = 16 / (int)sizeof(EP);
  constexpr int kPieces = D / kVE;   // 16-byte copies a key row
  const int tid = threadIdx.x;
  const int nst = (nslots + kKeys - 1) / kKeys;
  auto issue = [&](int c) {
    if (c < nst) {
      uint8_t* stg = kRing ? sm + L.ring + (c % kStages) * L.stage
                           : sm + L.cbuf;
      uint8_t* meta = kRing ? stg + L.meta : sm + L.cmeta;
      for (int e = tid; e < kKeys * kPieces; e += kThreads) {
        const int j = e / kPieces, pc = e - j * kPieces;
        const int s = c * kKeys + j;
        uint32_t row = 0;
        const bool live = s < nslots && addr(s, row);
        const EP* ksrc = kb + (size_t)row * D + pc * kVE;
        const EP* vsrc = vb + (size_t)row * D + pc * kVE;
        if constexpr (kQuant) {
          cp_async16(stg + j * D + pc * 16, ksrc, live ? 16 : 0);
          cp_async16(stg + L.raw_v + j * D + pc * 16, vsrc, live ? 16 : 0);
        } else {
          cp_async16(stg + TL::off(j, pc), ksrc, live ? 16 : 0);
          cp_async16(stg + (kRing ? L.raw_v : L.tile) + TL::off(j, pc),
                     vsrc, live ? 16 : 0);
        }
        if (pc == 0) {
          reinterpret_cast<int*>(meta)[j] = live;
          if constexpr (kQuant) {
            cp_async4(meta + kKeys * 4 + j * 4, ksb + row, live ? 4 : 0);
            cp_async4(meta + kKeys * 8 + j * 4, vsb + row, live ? 4 : 0);
          }
        }
      }
    }
    cp_async_commit();   // empty groups keep the wait counts uniform
  };
  if constexpr (kRing) {
#pragma unroll
    for (int c = 0; c < kStages - 1; ++c) issue(c);
    for (int c = 0; c < nst; ++c) {
      cp_async_wait<kStages - 2>();
      __syncthreads();   // stage c landed; stage c - 1's slot is free
      issue(c + kStages - 1);
      const uint8_t* stg = sm + L.ring + (c % kStages) * L.stage;
      const uint8_t* kt = stg;
      const uint8_t* vt = stg + L.raw_v;
      if constexpr (kQuant) {
        widen<D>(stg, sm + L.cbuf, L);
        __syncwarp();
        kt = sm + L.cbuf;
        vt = kt + L.tile;
      }
      attend_stage<D, kQuant>(st, sm + L.q, kt, vt, stg + L.meta,
                              c * kKeys, nmt, causal, tok0, group, sl2);
    }
  } else {
    for (int c = 0; c < nst; ++c) {
      issue(c);
      cp_async_wait<0>();
      __syncthreads();
      attend_stage<D, false>(st, sm + L.q, sm + L.cbuf, sm + L.cbuf + L.tile,
                             sm + L.cmeta, c * kKeys, nmt, causal, tok0,
                             group, sl2);
      __syncthreads();
    }
  }
}

// Everything the main and merge kernels read (device pointers).
struct ColdArgs {
  const __nv_bfloat16 *q, *k_new, *v_new;
  const void *k_pages, *v_pages;
  const float *k_scale, *v_scale;   // [L, N, P, KVH] (int8 pools)
  const int *t0, *q_len, *hist, *tables, *span_lo, *span_hi;
  const void *cold_k, *cold_v;
  const float *cold_ks, *cold_vs;   // [L, nC, Ct, KVH] (int8 slabs)
  const int *cold_row, *cold_len;
  const int4* items;                // [R, K] the pre-pass's list
  const int *row_n, *row_chunks;    // [R], [R, nC]
  int* counter;
  float *part_ml, *part_acc;        // [K, T, H, 2], [K, T, H, D]
  __nv_bfloat16* out;
  int T, H, KVH, N, P, R, maxP, layer, nC, Ct, K, span;
  float sl2;
};

// The pre-pass: row r's work list.  Slot 0 its fresh keys; its hot ranges
// [0, lo) and [hi, h) (h = hist clamped to the table's maxP P keys, the
// span clamped into [0, h)) in equal pieces of at most `span` keys; its
// owned chunks with cold_len > 0, ascending, in parts of `cpp` (more if
// the row would pass K items).  Block 0 also zeroes the work counter.
__global__ void __launch_bounds__(kPrepThreads)
cold_worklist_kernel(const int* __restrict__ hist,
                     const int* __restrict__ span_lo,
                     const int* __restrict__ span_hi,
                     const int* __restrict__ cold_row,
                     const int* __restrict__ cold_len, int4* items,
                     int* row_n, int* row_chunks, int* counter, int hot_cap,
                     int span, int nC, int cpp, int K) {
  const int r = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  __shared__ int s_count[kPrepThreads / 32];
  if (r == 0 && tid == 0) *counter = 0;
  int* mine = row_chunks + (size_t)r * nC;
  int n_own = 0;
  for (int c0 = 0; c0 < nC; c0 += kPrepThreads) {
    const int c = c0 + tid;
    const bool own = c < nC && cold_row[c] == r && cold_len[c] > 0;
    const unsigned bits = __ballot_sync(0xffffffffu, own);
    if (lane == 0) s_count[warp] = __popc(bits);
    __syncthreads();
    int before = n_own, total = 0;
    for (int w = 0; w < kPrepThreads / 32; ++w) {
      before += w < warp ? s_count[w] : 0;
      total += s_count[w];
    }
    if (own) mine[before + __popc(bits & ((1u << lane) - 1u))] = c;
    __syncthreads();
    n_own += total;
  }
  if (tid != 0) return;
  const int h = min(max(hist[r], 0), hot_cap);
  int lo = span_lo[r], hi = span_hi[r];
  if (lo >= hi) {
    lo = hi = h;
  } else {
    lo = min(max(lo, 0), h);
    hi = min(max(hi, lo), h);
  }
  int4* it = items + (size_t)r * K;
  int n = 0;
  it[n++] = make_int4(kFreshItem, 0, 0, 0);
  const int ranges[2][2] = {{0, lo}, {hi, h}};
  for (int q = 0; q < 2; ++q) {
    const int a = ranges[q][0], len = ranges[q][1] - a;
    const int pieces = len > 0 ? (len + span - 1) / span : 0;
    for (int i = 0; i < pieces; ++i)
      it[n++] = make_int4(kHotItem,
                          a + (int)((long long)len * i / pieces),
                          a + (int)((long long)len * (i + 1) / pieces), 0);
  }
  if (n_own > 0) {
    const int cap = K - n;   // >= 1: the host sized K for the hot pieces
    const int per = max(cpp, (n_own + cap - 1) / cap);
    for (int p = 0; p < n_own; p += per)
      it[n++] = make_int4(kColdItem, p, min(n_own, p + per), 0);
  }
  row_n[r] = n;
}

// Inclusive prefix sums of x[0, n) in place, by one warp.
__device__ __forceinline__ void warp_scan(int* x, int n) {
  const int lane = threadIdx.x & 31;
  int carry = 0;
  for (int i0 = 0; i0 < n; i0 += 32) {
    int v = i0 + lane < n ? x[i0 + lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += y;
    }
    v += carry;
    if (i0 + lane < n) x[i0 + lane] = v;
    carry = __shfl_sync(0xffffffffu, v, 31);
  }
}

// The last i in [0, n) with pre[i] <= u (pre ascending, pre[0] = 0).
__device__ __forceinline__ int last_leq(const int* pre, int n, int u) {
  int lo = 0, hi = n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (pre[mid] <= u)
      lo = mid;
    else
      hi = mid - 1;
  }
  return lo;
}

// The unit's (m, l, acc) into its slot: the warps' states merged in f32
// through shared memory (the drained ring), rows masked to the tile's.
template <int D>
__device__ __forceinline__ void finish_unit(uint8_t* sm, const ColdSmem& L,
                                            State<D>& st, int nmt, int rows,
                                            const ColdArgs& a, size_t slot0,
                                            int group) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  constexpr int kLd = D + 4;   // padded rows: fewer bank conflicts
  cp_async_wait<0>();
  __syncthreads();
  float* red_ml = reinterpret_cast<float*>(sm + L.ring);
  float* red_acc = reinterpret_cast<float*>(sm + L.ring + L.red_acc);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    if (mt >= nmt) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float l = st.l[mt][h];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      st.l[mt][h] = l;
      if (tq == 0) {
        const int row = 16 * mt + gq + 8 * h;
        red_ml[(warp * kMaxRows + row) * 2] = st.m[mt][h];
        red_ml[(warp * kMaxRows + row) * 2 + 1] = l;
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    if (mt >= nmt) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = 16 * mt + gq + 8 * h;
      float M = -INFINITY;
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
        M = fmaxf(M, red_ml[(w * kMaxRows + row) * 2]);
      const float wt = M == -INFINITY ? 0.f : exp2f(st.m[mt][h] - M);
      float* dst = red_acc + (warp * kMaxRows + row) * kLd + 2 * tq;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt)
        *reinterpret_cast<float2*>(dst + 8 * dt) =
            make_float2(st.acc[mt][dt][2 * h] * wt,
                        st.acc[mt][dt][2 * h + 1] * wt);
    }
  }
  __syncthreads();
  for (int e = tid; e < rows * D; e += kThreads) {
    const int row = e / D, d = e - row * D;
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      o += red_acc[(w * kMaxRows + row) * kLd + d];
    a.part_acc[(slot0 + (size_t)(row / group) * a.H + row % group) * D + d] =
        o;
  }
  for (int row = tid; row < rows; row += kThreads) {
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      M = fmaxf(M, red_ml[(w * kMaxRows + row) * 2]);
    float lsum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float m = red_ml[(w * kMaxRows + row) * 2];
      if (m != -INFINITY)
        lsum += red_ml[(w * kMaxRows + row) * 2 + 1] * exp2f(m - M);
    }
    const size_t i = slot0 + (size_t)(row / group) * a.H + row % group;
    a.part_ml[2 * i] = M;
    a.part_ml[2 * i + 1] = lsum;
  }
}

// One unit: query tile `tile` of row r, item k of its list, KV head g.
template <typename TP, int D>
__device__ __forceinline__ void run_unit(uint8_t* sm, const ColdSmem& L,
                                         const ColdArgs& a, int r, int tile,
                                         int k, int g, int group, int qb) {
  using TL = Tile<D>;
  constexpr bool kQuant = std::is_same<TP, int8_t>::value;
  const int tid = threadIdx.x;
  const int tok0 = tile * qb;
  const int ntok = min(qb, a.q_len[r] - tok0);
  const int rows = ntok * group;
  const int nmt = rows > 16 ? 2 : 1;
  const int base = a.t0[r];
  const int4 it = a.items[(size_t)r * a.K + k];
  // the tile's q rows (row i: token tok0 + i / group, head g group + i %
  // group: a token's group rows are contiguous in q); the rest stage as 0
  for (int e = tid; e < 16 * nmt * TL::kChunks; e += kThreads) {
    const int i = e / TL::kChunks, c = e - i * TL::kChunks;
    const bool ok = i < rows;
    const __nv_bfloat16* src =
        a.q + ((size_t)(base + tok0 + (ok ? i / group : 0)) * a.H +
               g * group + (ok ? i % group : 0)) * D + c * 8;
    cp_async16(sm + L.q + TL::off(i, c), src, ok ? 16 : 0);
  }
  State<D> st;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      st.m[mt][h] = -INFINITY;
      st.l[mt][h] = 0.f;
    }
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) st.acc[mt][dt][e] = 0.f;
  }
  KeyAddr addr;
  addr.win = reinterpret_cast<const int4*>(sm + L.win);
  addr.KVH = a.KVH;
  addr.g = g;
  if (it.x == kFreshItem) {
    addr.fresh = true;
    addr.kend = tok0 + ntok;   // the tile's last token sees up to itself
    addr.r0 = base * a.KVH + g;
    addr.pg = 1;
    addr.shift = 0;
    stream_keys<D, __nv_bfloat16, !kQuant>(
        sm, L, st, addr.kend, addr, a.k_new, a.v_new, nullptr, nullptr,
        nmt, true, tok0, group, a.sl2);
  } else {
    const bool hot = it.x == kHotItem;
    addr.fresh = false;
    addr.kend = 0;
    addr.r0 = 0;
    addr.pg = hot ? a.P : a.Ct;
    addr.shift = (addr.pg & (addr.pg - 1)) ? -1 : __ffs(addr.pg) - 1;
    int4* win = reinterpret_cast<int4*>(sm + L.win);
    const int first = hot ? it.y / a.P : it.y;
    const int last = hot ? (it.z - 1) / a.P + 1 : it.z;   // exclusive
    const TP* kb = static_cast<const TP*>(hot ? a.k_pages : a.cold_k);
    const TP* vb = static_cast<const TP*>(hot ? a.v_pages : a.cold_v);
    const float* ksb = hot ? a.k_scale : a.cold_ks;
    const float* vsb = hot ? a.v_scale : a.cold_vs;
    for (int w0 = first; w0 < last; w0 += kWin) {
      const int n = min(kWin, last - w0);
      for (int i = tid; i < n; i += kThreads) {
        int b, lo, hi;
        if (hot) {
          const int p = w0 + i;
          const int e = min(max(a.tables[(size_t)r * a.maxP + p], 0),
                            a.N - 1);
          b = (a.layer * a.N + e) * a.P;
          lo = max(it.y - p * a.P, 0);
          hi = min(it.z - p * a.P, a.P);
        } else {
          const int c = a.row_chunks[(size_t)r * a.nC + w0 + i];
          b = (a.layer * a.nC + c) * a.Ct;
          lo = 0;
          hi = min(a.cold_len[c], a.Ct);
        }
        win[i] = make_int4(b, lo, hi, 0);
      }
      __syncthreads();
      stream_keys<D, TP, true>(sm, L, st, n * addr.pg, addr, kb, vb, ksb,
                               vsb, nmt, false, tok0, group, a.sl2);
      cp_async_wait<0>();
      __syncthreads();   // the window and the ring are free again
    }
  }
  const size_t slot0 =
      ((size_t)k * a.T + base + tok0) * a.H + (size_t)g * group;
  finish_unit<D>(sm, L, st, nmt, rows, a, slot0, group);
}

// The main kernel: a fixed grid of blocks taking units (hot and cold
// units of every row, then the fresh ones) from the pre-pass's counter.
template <typename TP, int D>
__global__ void __launch_bounds__(kThreads, 2)
cold_attend_kernel(const ColdArgs a) {
  constexpr bool kQuant = std::is_same<TP, int8_t>::value;
  extern __shared__ __align__(128) uint8_t sm[];
  const ColdSmem L(D, kQuant, a.R);
  const int tid = threadIdx.x;
  const int group = a.H / a.KVH, qb = tile_tokens(group);
  // units per row: tiles x (items - 1) hot / cold, tiles fresh; prefixes
  int* pre_big = reinterpret_cast<int*>(sm + L.rows);
  int* pre_fresh = pre_big + a.R + 1;
  int* s_unit = pre_fresh + a.R + 1;
  for (int i = tid; i < a.R; i += kThreads) {
    const int tiles = (max(a.q_len[i], 0) + qb - 1) / qb;
    pre_big[i + 1] = tiles * (a.row_n[i] - 1);
    pre_fresh[i + 1] = tiles;
  }
  if (tid == 0) pre_big[0] = pre_fresh[0] = 0;
  __syncthreads();
  if (tid < 32) {
    warp_scan(pre_big + 1, a.R);
    warp_scan(pre_fresh + 1, a.R);
  }
  __syncthreads();
  const int n_big = pre_big[a.R];
  const int total = (n_big + pre_fresh[a.R]) * a.KVH;
  for (;;) {
    if (tid == 0) *s_unit = atomicAdd(a.counter, 1);
    __syncthreads();
    const int uf = *s_unit;
    __syncthreads();   // read by all before thread 0 writes it again
    if (uf >= total) break;
    const int g = uf % a.KVH;
    int u = uf / a.KVH, r, tile, k;
    if (u < n_big) {
      r = last_leq(pre_big, a.R, u);
      const int tiles = pre_fresh[r + 1] - pre_fresh[r];
      const int local = u - pre_big[r];
      k = 1 + local / tiles;
      tile = local - (k - 1) * tiles;
    } else {
      u -= n_big;
      r = last_leq(pre_fresh, a.R, u);
      tile = u - pre_fresh[r];
      k = 0;
    }
    run_unit<TP, D>(sm, L, a, r, tile, k, g, group, qb);
  }
}

// Merge: each (token, head) of a tile combines its row's slots 0 ..
// row_n - 1 in f32, in list order, and rounds once.  grid (tiles_bound,
// KVH, 4): a warp per (token, head), block z taking pairs [8 z, 8 z + 8).
template <int D>
__global__ void __launch_bounds__(kMergeThreads)
cold_merge_kernel(const ColdArgs a) {
  const int group = a.H / a.KVH, qb = tile_tokens(group);
  extern __shared__ int q_len_s[];   // the rows' q_len, for the tile search
  for (int i = threadIdx.x; i < a.R; i += kMergeThreads)
    q_len_s[i] = a.q_len[i];
  __syncthreads();
  int r, qtile;
  if (!find_tile(blockIdx.x, q_len_s, a.R, qb, r, qtile)) return;
  const int g = blockIdx.y;
  const int tok0 = qtile * qb;
  const int ntok = min(qb, q_len_s[r] - tok0);
  const int base = a.t0[r], np = a.row_n[r];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int pair = blockIdx.z * (kMergeThreads / 32) + warp;
  if (pair < ntok * group) {
    const size_t t = base + tok0 + pair / group;
    const int hh = g * group + pair % group;
    auto at = [&](int p) { return ((size_t)p * a.T + t) * a.H + hh; };
    float mx = -INFINITY;
    for (int p = lane; p < np; p += 32) mx = fmaxf(mx, a.part_ml[2 * at(p)]);
#pragma unroll
    for (int o = 16; o; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float lsum = 0.f, o4[4] = {0.f, 0.f, 0.f, 0.f};
    for (int p0 = 0; p0 < np; p0 += 32) {
      float w = 0.f;
      if (p0 + lane < np) {
        const size_t i = at(p0 + lane);
        w = exp2f(a.part_ml[2 * i] - mx);
        lsum += a.part_ml[2 * i + 1] * w;
      }
      const int n = min(32, np - p0);
      // 8 slots' loads in flight before their sums, in list order
      for (int p1 = 0; p1 < n; p1 += 8) {
        float4 v[8];
#pragma unroll
        for (int u = 0; u < 8; ++u)
          if (p1 + u < n && 4 * lane < D)
            v[u] = *reinterpret_cast<const float4*>(
                a.part_acc + at(p0 + p1 + u) * D + 4 * lane);
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const float wp = __shfl_sync(0xffffffffu, w, (p1 + u) & 31);
          if (p1 + u < n && 4 * lane < D) {
            o4[0] += v[u].x * wp;
            o4[1] += v[u].y * wp;
            o4[2] += v[u].z * wp;
            o4[3] += v[u].w * wp;
          }
        }
      }
    }
#pragma unroll
    for (int o = 16; o; o >>= 1) lsum += __shfl_xor_sync(0xffffffffu, lsum, o);
    if (4 * lane < D) {
      const float inv = 1.f / (lsum > 0.f ? lsum : 1.f);
      __nv_bfloat16* dst = a.out + (t * a.H + hh) * D + 4 * lane;
#pragma unroll
      for (int d = 0; d < 4; ++d) dst[d] = __float2bfloat16(o4[d] * inv);
    }
  }
}

// The work list's layout in the wrapper's int32 buffer: items [R, K] (4
// ints each), row_n [R], row_chunks [R, nC], the counter.
struct WorkList {
  int4* items;
  int *row_n, *row_chunks, *counter;
  WorkList(int* w, int R, int K, int nC) {
    items = reinterpret_cast<int4*>(w);
    row_n = w + 4 * (size_t)R * K;
    row_chunks = row_n + R;
    counter = row_chunks + (size_t)R * nC;
  }
};

cudaError_t launch_worklist(const ColdArgs& a, const WorkList& wl,
                            cudaStream_t s) {
  const int cpp = max(1, min(a.span / a.Ct, kWin));
  cold_worklist_kernel<<<a.R, kPrepThreads, 0, s>>>(
      a.hist, a.span_lo, a.span_hi, a.cold_row, a.cold_len, wl.items,
      wl.row_n, wl.row_chunks, wl.counter, a.maxP * a.P, a.span, a.nC, cpp,
      a.K);
  return cudaGetLastError();
}

bool shapes_ok(const ColdArgs& a) {
  if (a.KVH <= 0 || a.H % a.KVH || a.H / a.KVH > kMaxRows) return false;
  if (a.span <= 0 || a.nC <= 0 || a.Ct <= 0 || a.P <= 0 || a.maxP <= 0)
    return false;
  // a row's pieces of [0, lo) and [hi, hist) fit K - 2 slots
  if (a.K < (a.maxP * (long long)a.P + a.span - 1) / a.span + 4) return false;
  // pool, slab and fresh rows (slot x KVH + head) as 32-bit
  return (a.layer + 1LL) * a.N * a.P * a.KVH < (1LL << 31) &&
         (a.layer + 1LL) * a.nC * a.Ct * a.KVH < (1LL << 31) &&
         (long long)a.T * a.KVH < (1LL << 31);
}

template <typename TP, int D>
cudaError_t launch(ColdArgs a, int* work, cudaStream_t s, int* info) {
  constexpr bool kQuant = std::is_same<TP, int8_t>::value;
  const ColdSmem L(D, kQuant, a.R);
  auto kern = cold_attend_kernel<TP, D>;
  if (info) return kernel_info(kern, kThreads, L.total, info);
  if (!shapes_ok(a)) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
  if (err != cudaSuccess) return err;
  const WorkList wl(work, a.R, a.K, a.nC);
  err = launch_worklist(a, wl, s);
  if (err != cudaSuccess) return err;
  a.items = wl.items;
  a.row_n = wl.row_n;
  a.row_chunks = wl.row_chunks;
  a.counter = wl.counter;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                      kThreads, L.total);
  if (err != cudaSuccess) return err;
  const int qb = tile_tokens(a.H / a.KVH);
  const int tiles = tiles_bound(a.T, qb, a.R);
  const long long units = (long long)tiles * a.K * a.KVH;
  const int grid = (int)min((long long)max(per_sm, 1) * sms, units);
  kern<<<grid, kThreads, L.total, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 merge_grid(tiles, a.KVH, kMaxRows / (kMergeThreads / 32));
  cold_merge_kernel<D><<<merge_grid, kMergeThreads, a.R * 4, s>>>(a);
  return cudaGetLastError();
}

template <typename TP>
cudaError_t dispatch(int D, const ColdArgs& a, int* work, cudaStream_t s,
                     int* info) {
  switch (D) {
    case 16: return launch<TP, 16>(a, work, s, info);
    case 32: return launch<TP, 32>(a, work, s, info);
    case 64: return launch<TP, 64>(a, work, s, info);
    case 96: return launch<TP, 96>(a, work, s, info);
    case 128: return launch<TP, 128>(a, work, s, info);
    default: return cudaErrorInvalidValue;
  }
}

ColdArgs make_args(const void* q, const void* k_new, const void* v_new,
                   const void* k_pages, const void* v_pages,
                   const void* k_scale, const void* v_scale, const void* t0,
                   const void* q_len, const void* hist, const void* tables,
                   const void* span_lo, const void* span_hi,
                   const void* cold_k, const void* cold_v,
                   const void* cold_ks, const void* cold_vs,
                   const void* cold_row, const void* cold_len, void* out,
                   void* part_ml, void* part_acc, int T, int H, int KVH,
                   int N, int P, int R, int maxP, int layer, int nC, int Ct,
                   int K, int span, float scale) {
  ColdArgs a{};
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k_new = static_cast<const __nv_bfloat16*>(k_new);
  a.v_new = static_cast<const __nv_bfloat16*>(v_new);
  a.k_pages = k_pages;
  a.v_pages = v_pages;
  a.k_scale = static_cast<const float*>(k_scale);
  a.v_scale = static_cast<const float*>(v_scale);
  a.t0 = static_cast<const int*>(t0);
  a.q_len = static_cast<const int*>(q_len);
  a.hist = static_cast<const int*>(hist);
  a.tables = static_cast<const int*>(tables);
  a.span_lo = static_cast<const int*>(span_lo);
  a.span_hi = static_cast<const int*>(span_hi);
  a.cold_k = cold_k;
  a.cold_v = cold_v;
  a.cold_ks = static_cast<const float*>(cold_ks);
  a.cold_vs = static_cast<const float*>(cold_vs);
  a.cold_row = static_cast<const int*>(cold_row);
  a.cold_len = static_cast<const int*>(cold_len);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.part_ml = static_cast<float*>(part_ml);
  a.part_acc = static_cast<float*>(part_acc);
  a.T = T;
  a.H = H;
  a.KVH = KVH;
  a.N = N;
  a.P = P;
  a.R = R;
  a.maxP = maxP;
  a.layer = layer;
  a.nC = nC;
  a.Ct = Ct;
  a.K = K;
  a.span = span;
  a.sl2 = scale * kLog2e;
  return a;
}

}  // namespace
}  // namespace helix

// bf16 queries, fresh K/V and output; bf16 pools [L, N, P, KVH, D] and
// slab [L, nC, Ct, KVH, D]; t0/q_len/hist/span_lo/span_hi [R],
// tables [R, maxP], cold_row/cold_len [nC] int32, all contiguous device
// memory.  part_ml [K, T, H, 2] / part_acc [K, T, H, D] float32 and `work`
// (4 R K + R + R nC + 1 int32) are scratch; K >= ceil(maxP P / span) + 4.
extern "C" int helix_ragged_paged_attention_cold_bf16(
    const void* q, const void* k_new, const void* v_new, const void* k_pages,
    const void* v_pages, const void* t0, const void* q_len, const void* hist,
    const void* tables, const void* span_lo, const void* span_hi,
    const void* cold_k, const void* cold_v, const void* cold_row,
    const void* cold_len, void* out, void* part_ml, void* part_acc,
    void* work, int T, int H, int KVH, int D, int N, int P, int R, int maxP,
    int layer, int nC, int Ct, int K, int span, float scale, void* stream) {
  if (T <= 0 || R <= 0) return cudaSuccess;
  const helix::ColdArgs a = helix::make_args(
      q, k_new, v_new, k_pages, v_pages, nullptr, nullptr, t0, q_len, hist,
      tables, span_lo, span_hi, cold_k, cold_v, nullptr, nullptr, cold_row,
      cold_len, out, part_ml, part_acc, T, H, KVH, N, P, R, maxP, layer, nC,
      Ct, K, span, scale);
  return static_cast<int>(helix::dispatch<__nv_bfloat16>(
      D, a, static_cast<int*>(work), static_cast<cudaStream_t>(stream),
      nullptr));
}

// The int8 pools' form: int8 pools and slab with their float32 scale pools
// k_scale/v_scale [L, N, P, KVH] and cold_k_scale/cold_v_scale [L, nC, Ct,
// KVH]; queries, fresh K/V and output bf16.
extern "C" int helix_ragged_paged_attention_int8_cold_bf16(
    const void* q, const void* k_new, const void* v_new, const void* k_pages,
    const void* v_pages, const void* k_scale, const void* v_scale,
    const void* t0, const void* q_len, const void* hist, const void* tables,
    const void* span_lo, const void* span_hi, const void* cold_k,
    const void* cold_v, const void* cold_k_scale, const void* cold_v_scale,
    const void* cold_row, const void* cold_len, void* out, void* part_ml,
    void* part_acc, void* work, int T, int H, int KVH, int D, int N, int P,
    int R, int maxP, int layer, int nC, int Ct, int K, int span, float scale,
    void* stream) {
  if (T <= 0 || R <= 0) return cudaSuccess;
  const helix::ColdArgs a = helix::make_args(
      q, k_new, v_new, k_pages, v_pages, k_scale, v_scale, t0, q_len, hist,
      tables, span_lo, span_hi, cold_k, cold_v, cold_k_scale, cold_v_scale,
      cold_row, cold_len, out, part_ml, part_acc, T, H, KVH, N, P, R, maxP,
      layer, nC, Ct, K, span, scale);
  return static_cast<int>(helix::dispatch<int8_t>(
      D, a, static_cast<int*>(work), static_cast<cudaStream_t>(stream),
      nullptr));
}

// The pre-pass alone (its list is checked against the plain one): writes
// `work` as the forms above lay it out.
extern "C" int helix_ragged_paged_attention_cold_worklist(
    const void* hist, const void* span_lo, const void* span_hi,
    const void* cold_row, const void* cold_len, void* work, int R, int P,
    int maxP, int nC, int Ct, int K, int span, void* stream) {
  if (R <= 0) return cudaSuccess;
  helix::ColdArgs a{};
  a.hist = static_cast<const int*>(hist);
  a.span_lo = static_cast<const int*>(span_lo);
  a.span_hi = static_cast<const int*>(span_hi);
  a.cold_row = static_cast<const int*>(cold_row);
  a.cold_len = static_cast<const int*>(cold_len);
  a.R = R;
  a.P = P;
  a.maxP = maxP;
  a.nC = nC;
  a.Ct = Ct;
  a.K = K;
  a.span = span;
  a.H = a.KVH = 1;
  a.N = 1;
  if (!helix::shapes_ok(a)) return cudaErrorInvalidValue;
  const helix::WorkList wl(static_cast<int*>(work), R, K, nC);
  return static_cast<int>(
      helix::launch_worklist(a, wl, static_cast<cudaStream_t>(stream)));
}

// Launch resources of the main kernel at head dim D for R rows: info[4] =
// shared memory per block (bytes), registers per thread, blocks per SM,
// spill bytes per thread.
extern "C" int helix_ragged_paged_attention_cold_bf16_info(int D,
                                                            int quantized,
                                                            int R,
                                                            int* info) {
  helix::ColdArgs a{};
  a.R = R;
  if (quantized)
    return static_cast<int>(
        helix::dispatch<int8_t>(D, a, nullptr, nullptr, info));
  return static_cast<int>(
      helix::dispatch<__nv_bfloat16>(D, a, nullptr, nullptr, info));
}
