// The residual stage shared by the CTU kernels (K2 inter_fused.cu, B3
// bi_fused.cu, B19 mega.cu, B4 residual_ctu.cu), and the integer helpers
// the kernels share.
//
// residual_tile<TU, DST> codes one W x W tile of a 64x64 CTU (W = 16 for TU
// in {4, 8, 16}, 32 for TU = 32; DST selects the 4x4 DST-VII) against its
// prediction, by one warp, as hevcasm_tpu/kernels/residual_pallas.py
// residual_core (and, at TU = 8, residual_core_stacked) does:
//
//   5. forward transform, rows then columns (shifts log2(TU) - 1 and
//      log2(TU) + 6, int16 wrap after each pass);
//   6. quantize, per-TU nnz and Exp-Golomb bits 2*floor(log2|q|) + 3;
//   7. dequantize, inverse transform, columns then rows (shifts 7 and 12,
//      clipped to int16), add the prediction and clip to 8 bits.
//
// The four passes run on the tensor cores, mma.sync with s8 and u8
// operands and exact s32 sums (m16n8k16 for W = 16, m16n8k32 for W = 32).
// With X the residual, T the transform and BT = kron(I, T) its
// block-diagonal form over the tile, each pass is one product, the data
// alternately the B and the A operand, so that every pass's accumulator
// fragments are the next pass's operand fragments in the same lanes:
//
//   forward rows     s1^T = BT X^T      A = BT (s8), B = src and pred rows (u8)
//   forward columns  C^T  = s1^T BT^T   A = s1^T (hi s8, lo u8), B = BT^T (s8)
//   inverse columns  r1   = BT^T dq     A = BT^T (s8), B = dq (hi s8, lo u8)
//   inverse rows     r2   = r1 BT       A = r1 (hi s8, lo u8), B = BT (s8)
//
// Lane (g, t) of an m16n8 accumulator holds rows g and g + 8 of columns 2t
// and 2t + 1; over two n tiles, columns 2t, 2t + 1, 8 + 2t and 9 + 2t of
// the 16 the next product contracts, whereas an operand fragment holds k
// indices 4t .. 4t + 3.  So the contraction order is permuted, k = 4t + i
// standing for index perm(4t + i) = 2t + (i & 1) + 8 (i >> 1) (and 16 more
// in the upper half of a k32 fragment), and the constant operands are laid
// out in that order: the int32 results go to the next product through no
// memory and no shuffle, only split into bytes.  The residual X = src -
// pred is never formed: its product is T src - T pred, two u8 products
// into one accumulator, exact.  The int16 intermediates enter their
// products as hi = v >> 8 (s8) and lo = v & 255 (u8), 256 hi + lo = v; no
// sum leaves int32 (at most 32 x 90 x 32768 < 2^31).  The constant
// fragments, a lane's words of each TU size's bands, are a table built at
// compile time (frag_table) and read through the read-only cache.
//
// Quantize, dequantize, nnz and bits run on the CUDA cores, in the
// accumulator fragments of the forward columns; the per-TU counts (nnz in
// the low and bits in the high 16 bits of one word) are reduced across the
// lanes by shuffles and stored by the lanes that end with them.  A tile
// needs no shared memory and meets no barrier.
//
// All arithmetic is int32.  The quantizer products are formed in uint32 so
// that an out-of-range parameter wraps as two's-complement int32 does in
// the reference instead of overflowing a signed int.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int B = 64;           // CTU size
constexpr int NT = 256;         // threads per block of the CTU kernels

__device__ __forceinline__ int wrap16(int v) {
  return static_cast<int>(static_cast<uint32_t>(v) << 16) >> 16;
}

__device__ __forceinline__ int clip3(int lo, int hi, int v) {
  return min(max(v, lo), hi);
}

// The 4-byte word at p (4-byte aligned), byte 0 the lowest.
__device__ __forceinline__ uint32_t lds32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// HEVC forward quantization of one coefficient (quantize.c semantics).
__device__ __forceinline__ int quantize(int c, int qscale, int qshift,
                                        int qoffset) {
  const uint32_t a = static_cast<uint32_t>(c < 0 ? -c : c);
  const uint32_t t = a * static_cast<uint32_t>(qscale) +
                     (static_cast<uint32_t>(qoffset) << (qshift - 16));
  const int q = static_cast<int>(t) >> qshift;
  return clip3(-32768, 32767, c < 0 ? -q : q);
}

__device__ __forceinline__ int dequantize(int q, int dscale, int dshift) {
  const uint32_t t = static_cast<uint32_t>(q) * static_cast<uint32_t>(dscale) +
                     (1u << (dshift - 1));
  return clip3(-32768, 32767, static_cast<int>(t) >> dshift);
}

__device__ __forceinline__ int egk_bits(int q) {
  const uint32_t a = static_cast<uint32_t>(q < 0 ? -q : q);
  return a ? 2 * (31 - __clz(a)) + 3 : 0;
}

// The five quantizer parameters, in the C entries' order.
struct QParams {
  int qscale, qshift, qoffset, dscale, dshift;
};

namespace restc {

// ---- the constant fragments, built at compile time ----------------------
//
// Variant v: 0 the 4x4 DST-VII, 1-4 the 4-, 8-, 16- and 32-point DCT.
// Word w of lane l of variant v is words[v][w][l]:
//   0 + 4 mt + r    forward rows' A, register r of m tile mt: BT rows
//                   (output u) 16 mt + g + 8 (r & 1), k = x = 4t + i + 16 (r >> 1);
//   8 + 2 j + s     forward columns' B, register s of n tile j: output
//                   v = 8 j + g, k = y = perm(4t + i + 16 s);
//   16 + 4 mt + r   inverse columns' A: output y = 16 mt + g + 8 (r & 1),
//                   k = v = perm(4t + i + 16 (r >> 1));
//   24 + 2 j + s    inverse rows' B: output x = 8 j + g, k = u = perm(4t + i + 16 s);
// byte i of a word holding the entry for its k.  At W = 16 only mt = 0,
// r < 2, j < 2, s = 0 are read.
constexpr int VARIANTS = 5;
constexpr int WORDS = 32;

struct FragTable {
  uint32_t words[VARIANTS][WORDS][32];
};

// The contraction index that operand position p (0..31) stands for.
__host__ __device__ constexpr int perm(int p) {
  return (p & 16) + 2 * ((p & 15) >> 2) + (p & 1) + 8 * ((p >> 1) & 1);
}

__host__ __device__ constexpr uint32_t pack_bytes(const int (&b)[4]) {
  return (static_cast<uint32_t>(b[0]) & 255u) | ((static_cast<uint32_t>(b[1]) & 255u) << 8) |
         ((static_cast<uint32_t>(b[2]) & 255u) << 16) |
         ((static_cast<uint32_t>(b[3]) & 255u) << 24);
}

__host__ __device__ constexpr FragTable frag_table() {
  // T32[k][j]: the integer cosine at angle k (2j + 1) pi / 64, read from
  // the first column with the sign of its quadrant (H.265 8.6.4.2); the
  // N-point DCT is rows 0, 32/N, ... cut to N columns.
  const int first_col[32] = {64, 90, 90, 90, 89, 88, 87, 85, 83, 82, 80, 78, 75, 73, 70, 67,
                             64, 61, 57, 54, 50, 46, 43, 38, 36, 31, 25, 22, 18, 13, 9, 4};
  const int dst4[4][4] = {{29, 55, 74, 84}, {74, 74, 0, -74}, {84, -29, -74, 55},
                          {55, -84, 74, -29}};
  int t32[32][32] = {};
  for (int k = 0; k < 32; ++k)
    for (int j = 0; j < 32; ++j) {
      int phase = (k * (2 * j + 1)) % 128, sign = 1;
      if (phase >= 64) {
        sign = -1;
        phase -= 64;
      }
      const int val = phase > 32 ? -first_col[64 - phase] : phase == 32 ? 0 : first_col[phase];
      t32[k][j] = sign * val;
    }
  FragTable f = {};
  for (int v = 0; v < VARIANTS; ++v) {
    const int tu = v == 0 ? 4 : 2 << v, w = tu == 32 ? 32 : 16;
    // band[a][b]: BT's entry for output (frequency) a, input (position) b.
    int band[32][32] = {};
    for (int a = 0; a < w; ++a)
      for (int b = 0; b < w; ++b)
        if (a / tu == b / tu)
          band[a][b] = v == 0 ? dst4[a % 4][b % 4] : t32[(a % tu) * (32 / tu)][b % tu];
    for (int lane = 0; lane < 32; ++lane) {
      const int g = lane >> 2, t = lane & 3;
      for (int mt = 0; mt < w / 16; ++mt)
        for (int r = 0; r < w / 8; ++r) {
          int fwd[4] = {}, inv[4] = {};
          for (int i = 0; i < 4; ++i) {
            const int row = 16 * mt + g + 8 * (r & 1), k = 4 * t + i + 16 * (r >> 1);
            fwd[i] = band[row][k];
            inv[i] = band[perm(k)][row];
          }
          f.words[v][4 * mt + r][lane] = pack_bytes(fwd);
          f.words[v][16 + 4 * mt + r][lane] = pack_bytes(inv);
        }
      for (int j = 0; j < w / 8; ++j)
        for (int s = 0; s < w / 16; ++s) {
          int fwd[4] = {}, inv[4] = {};
          for (int i = 0; i < 4; ++i) {
            const int k = perm(4 * t + i + 16 * s);
            fwd[i] = band[8 * j + g][k];
            inv[i] = band[k][8 * j + g];
          }
          f.words[v][8 + 2 * j + s][lane] = pack_bytes(fwd);
          f.words[v][24 + 2 * j + s][lane] = pack_bytes(inv);
        }
    }
  }
  return f;
}

__device__ const FragTable FRAGS = frag_table();

// ---- the tile's geometry ----------------------------------------------------

template <int TU_, bool DST_>
struct Tile {
  static_assert(TU_ == 4 || TU_ == 8 || TU_ == 16 || TU_ == 32, "TU size");
  static_assert(!DST_ || TU_ == 4, "the DST-VII is 4x4 only");
  static constexpr int TU = TU_;
  static constexpr int W = TU == 32 ? 32 : 16;   // tile side, the products' k depth
  static constexpr int SIDE = B / W;             // tiles a CTU side
  static constexpr int MT = W / 16;              // m16 tiles of a product
  static constexpr int NTL = W / 8;              // n8 tiles of a product
  static constexpr int AR = W / 8;               // registers of an A fragment
  static constexpr int BR = W / 16;              // registers of a B fragment
  static constexpr int LOG2 = TU == 4 ? 2 : TU == 8 ? 3 : TU == 16 ? 4 : 5;
  static constexpr int S1 = LOG2 - 1, S2 = LOG2 + 6;   // forward shifts
  static constexpr int VAR = DST_ ? 0 : LOG2 - 1;      // FragTable variant
};

__device__ __forceinline__ uint32_t frag_word(int variant, int word) {
  return __ldg(&FRAGS.words[variant][word][threadIdx.x & 31]);
}

// d += a * b with s32 sums: m16n8k16 (W = 16) or m16n8k32 (W = 32); the
// suffix names the A and the B type.
#define RESTC_MMA(NAME, AT, BT)                                                             \
  template <int W>                                                                          \
  __device__ __forceinline__ void NAME(int (&d)[4], const uint32_t (&a)[W / 8],             \
                                       const uint32_t (&b)[W / 16]) {                       \
    if constexpr (W == 16) {                                                                \
      asm("mma.sync.aligned.m16n8k16.row.col.s32." AT "." BT ".s32 "                        \
          "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"                           \
          : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])                                  \
          : "r"(a[0]), "r"(a[1]), "r"(b[0]));                                               \
    } else {                                                                                \
      asm("mma.sync.aligned.m16n8k32.row.col.s32." AT "." BT ".s32 "                        \
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"               \
          : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])                                  \
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));              \
    }                                                                                       \
  }
RESTC_MMA(mma_s8u8, "s8", "u8")
RESTC_MMA(mma_s8s8, "s8", "s8")
RESTC_MMA(mma_u8s8, "u8", "s8")
#undef RESTC_MMA

// The low 16 bits of v0..v3 as two words: hi holds their bytes 1 (s8),
// lo their bytes 0 (u8), byte i from v_i.
__device__ __forceinline__ void split4(int v0, int v1, int v2, int v3, uint32_t& hi,
                                       uint32_t& lo) {
  const uint32_t p01 = __byte_perm(static_cast<uint32_t>(v0), static_cast<uint32_t>(v1), 0x5410);
  const uint32_t p23 = __byte_perm(static_cast<uint32_t>(v2), static_cast<uint32_t>(v3), 0x5410);
  hi = __byte_perm(p01, p23, 0x7531);
  lo = __byte_perm(p01, p23, 0x6420);
}

// An accumulator over n tiles, acc[j][r] (n tile j, register r: row g + 8
// (r >> 1), column 8 j + 2t + (r & 1)), as the A fragment of a product that
// contracts those columns in perm order: register r holds row g + 8 (r & 1)
// at k = 4t + i + 16 (r >> 1), i.e. acc[2 (r >> 1) + (i >> 1)][2 (r & 1) + (i & 1)].
template <class S>
__device__ __forceinline__ void a_fragments(const int (&acc)[S::NTL][4], uint32_t (&hi)[S::AR],
                                            uint32_t (&lo)[S::AR]) {
#pragma unroll
  for (int r = 0; r < S::AR; ++r) {
    const int j = 2 * (r >> 1), c = 2 * (r & 1);
    split4(acc[j][c], acc[j][c + 1], acc[j + 1][c], acc[j + 1][c + 1], hi[r], lo[r]);
  }
}

// ---- the four passes (a tile's pointers at its top-left pixel, rows B apart)

// Forward rows of m tile mt: s1[j][r] = (BT X^T)[16 mt + g + 8 (r >> 1)][8 j
// + 2t + (r & 1)] >> S1, i.e. output column u, source row y; the int16 wrap
// is the byte split that follows.  B: 4 bytes of a source and a prediction
// row, at k = x = 4t .. 4t + 3 (+ 16).
template <class S>
__device__ __forceinline__ void forward_rows(const uint8_t* src, const uint8_t* pred, int mt,
                                             int (&s1)[S::NTL][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  uint32_t a[S::AR];
#pragma unroll
  for (int r = 0; r < S::AR; ++r) a[r] = frag_word(S::VAR, 4 * mt + r);
#pragma unroll
  for (int j = 0; j < S::NTL; ++j) {
    const int off = (8 * j + g) * B + 4 * t;
    uint32_t bs[S::BR], bp[S::BR];
#pragma unroll
    for (int s = 0; s < S::BR; ++s) {
      bs[s] = lds32(src + off + 16 * s);
      bp[s] = lds32(pred + off + 16 * s);
    }
    int d[4] = {0, 0, 0, 0};
    mma_s8u8<S::W>(d, a, bp);
#pragma unroll
    for (int r = 0; r < 4; ++r) d[r] = (1 << (S::S1 - 1)) - d[r];
    mma_s8u8<S::W>(d, a, bs);
#pragma unroll
    for (int r = 0; r < 4; ++r) s1[j][r] = d[r] >> S::S1;
  }
}

// Forward columns of m tile mt (outputs u = 16 mt + g + 8 (r >> 1)), the
// quantizer and the counts: coefficient C[v][u] for v = 8 j + 2t + (r & 1),
// its level's count into counts[2 j + (r >> 1)] (the TU of (v, u) in the
// tile at 4x4 and 8x8; counts[0] above), its dequantized level into the B
// fragments of the inverse columns for u groups 2 mt and 2 mt + 1 (u = 8 n
// + g): register s holds k = v = perm(4t + i + 16 s).
template <class S>
__device__ __forceinline__ void forward_columns(const int (&s1)[S::NTL][4], int mt,
                                                const QParams& qp,
                                                uint32_t (&dqh)[S::NTL][S::BR],
                                                uint32_t (&dql)[S::NTL][S::BR],
                                                uint32_t (&counts)[4]) {
  uint32_t ah[S::AR], al[S::AR];
  a_fragments<S>(s1, ah, al);
  int dq[S::NTL][4];
#pragma unroll
  for (int j = 0; j < S::NTL; ++j) {
    uint32_t b[S::BR];
#pragma unroll
    for (int s = 0; s < S::BR; ++s) b[s] = frag_word(S::VAR, 8 + 2 * j + s);
    int d[4] = {0, 0, 0, 0};
    mma_s8s8<S::W>(d, ah, b);
#pragma unroll
    for (int r = 0; r < 4; ++r) d[r] = 256 * d[r] + (1 << (S::S2 - 1));
    mma_u8s8<S::W>(d, al, b);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int q = quantize(wrap16(d[r] >> S::S2), qp.qscale, qp.qshift, qp.qoffset);
      const uint32_t e = static_cast<uint32_t>(egk_bits(q));
      counts[S::TU <= 8 ? 2 * j + (r >> 1) : 0] += (e << 16) | (e != 0u);
      dq[j][r] = dequantize(q, qp.dscale, qp.dshift);
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int s = 0; s < S::BR; ++s)
      split4(dq[2 * s][2 * h], dq[2 * s][2 * h + 1], dq[2 * s + 1][2 * h],
             dq[2 * s + 1][2 * h + 1], dqh[2 * mt + h][s], dql[2 * mt + h][s]);
}

// Inverse columns of m tile mt: r1[n][r] = clip16((BT^T dq + 64) >> 7) at row
// y = 16 mt + g + 8 (r >> 1), column u = 8 n + 2t + (r & 1).
template <class S>
__device__ __forceinline__ void inverse_columns(const uint32_t (&dqh)[S::NTL][S::BR],
                                                const uint32_t (&dql)[S::NTL][S::BR], int mt,
                                                int (&r1)[S::NTL][4]) {
  uint32_t a[S::AR];
#pragma unroll
  for (int r = 0; r < S::AR; ++r) a[r] = frag_word(S::VAR, 16 + 4 * mt + r);
#pragma unroll
  for (int n = 0; n < S::NTL; ++n) {
    int d[4] = {0, 0, 0, 0};
    mma_s8s8<S::W>(d, a, dqh[n]);
#pragma unroll
    for (int r = 0; r < 4; ++r) d[r] = 256 * d[r] + 64;
    mma_s8u8<S::W>(d, a, dql[n]);
#pragma unroll
    for (int r = 0; r < 4; ++r) r1[n][r] = clip3(-32768, 32767, d[r] >> 7);
  }
}

// Inverse rows of m tile mt, the add and the clip: pixel (y, x) = (16 mt +
// g + 8 (r >> 1), 8 j + 2t + (r & 1)) of out is clip(pred + clip16((r1 BT +
// 2048) >> 12), 0, 255), a lane's two pixels of a row as one 16-bit store.
// The int16 clip is left out: with r1 clipped, |v| <= 64 TU 32767 / 4096
// <= 2^14 never reaches it.
template <class S>
__device__ __forceinline__ void inverse_rows(const int (&r1)[S::NTL][4], const uint8_t* pred,
                                             uint8_t* __restrict__ out, int mt) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  uint32_t ah[S::AR], al[S::AR];
  a_fragments<S>(r1, ah, al);
#pragma unroll
  for (int j = 0; j < S::NTL; ++j) {
    uint32_t b[S::BR];
#pragma unroll
    for (int s = 0; s < S::BR; ++s) b[s] = frag_word(S::VAR, 24 + 2 * j + s);
    int d[4] = {0, 0, 0, 0};
    mma_s8s8<S::W>(d, ah, b);
#pragma unroll
    for (int r = 0; r < 4; ++r) d[r] = 256 * d[r] + 2048;
    mma_u8s8<S::W>(d, al, b);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int off = (16 * mt + g + 8 * h) * B + 8 * j + 2 * t;
      const uint32_t p = *reinterpret_cast<const uint16_t*>(pred + off);
      const int lo = clip3(0, 255, static_cast<int>(p & 255u) + (d[2 * h] >> 12));
      const int hi = clip3(0, 255, static_cast<int>(p >> 8) + (d[2 * h + 1] >> 12));
      *reinterpret_cast<uint16_t*>(out + off) = static_cast<uint16_t>(lo | (hi << 8));
    }
  }
}

// The tile's per-TU counts, reduced across the warp, to nnz (and bits unless
// null) of the CTU, (B / TU)^2 ints in TU-grid order; (ty, tx) is the tile.
// Above 8x8 the tile is one TU.  At 8x8 counts[2 j + h] is TU (2 ty + j,
// 2 tx + h) in every lane; at 4x4 TU (4 ty + 2 j + t / 2, 4 tx + 2 h + g /
// 4), shared by the lanes that differ in bits 0, 2 and 3.  Two halving
// exchanges leave each lane one count (slot (lane >> b) & 3), then sums.
template <int TU>
__device__ __forceinline__ void store_counts(uint32_t (&counts)[4], int32_t* __restrict__ nnz,
                                             int32_t* __restrict__ bits, int ty, int tx) {
  constexpr unsigned FULL = 0xffffffffu;
  constexpr int K = B / TU;
  const int lane = threadIdx.x & 31;
  uint32_t v;
  int idx;
  if constexpr (TU >= 16) {
    v = counts[0];
#pragma unroll
    for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
    idx = lane ? -1 : ty * K + tx;
  } else {
    constexpr int X1 = TU == 8 ? 16 : 8, X2 = X1 / 2;   // the halving exchanges
    const bool up1 = lane & X1, up2 = lane & X2;
    const uint32_t p0 = (up1 ? counts[2] : counts[0]) +
                        __shfl_xor_sync(FULL, up1 ? counts[0] : counts[2], X1);
    const uint32_t p1 = (up1 ? counts[3] : counts[1]) +
                        __shfl_xor_sync(FULL, up1 ? counts[1] : counts[3], X1);
    v = (up2 ? p1 : p0) + __shfl_xor_sync(FULL, up2 ? p0 : p1, X2);
    const int slot = 2 * up1 + up2, j = slot >> 1, h = slot & 1;
    if constexpr (TU == 8) {
#pragma unroll
      for (int o = 4; o; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
      idx = (lane & 7) ? -1 : (2 * ty + j) * K + 2 * tx + h;
    } else {
      v += __shfl_xor_sync(FULL, v, 1);
      idx = (lane & 1) ? -1
                       : (4 * ty + 2 * j + ((lane >> 1) & 1)) * K + 4 * tx + 2 * h + (lane >> 4);
    }
  }
  if (idx >= 0) {
    nnz[idx] = static_cast<int32_t>(v & 0xFFFFu);
    if (bits) bits[idx] = static_cast<int32_t>(v >> 16);
  }
}

}  // namespace restc

// Stages 5-7 for tile (ty, tx) of W x W of one CTU, by one warp: src and
// pred are the CTU's (B, B) uint8 (shared or device memory, 4-byte
// aligned, row stride B); writes the tile's pixels of out (the CTU's (B, B)
// uint8 in device memory) and its TUs' nnz (and bits unless null) of the
// CTU's (B / TU)^2 int32.  No shared memory, no barrier.
template <int TU, bool DST = false>
__device__ __forceinline__ void residual_tile(const uint8_t* src, const uint8_t* pred,
                                              uint8_t* __restrict__ out,
                                              int32_t* __restrict__ nnz,
                                              int32_t* __restrict__ bits, int ty, int tx,
                                              const QParams& qp) {
  using S = restc::Tile<TU, DST>;
  const int off = S::W * (ty * B + tx);
  src += off;
  pred += off;
  out += off;
  // The dequantized levels, as the inverse columns' B fragments of u groups
  // of 8; the counts, packed bits << 16 | nnz.
  uint32_t dqh[S::NTL][S::BR], dql[S::NTL][S::BR];
  uint32_t counts[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int mt = 0; mt < S::MT; ++mt) {
    int s1[S::NTL][4];
    restc::forward_rows<S>(src, pred, mt, s1);
    restc::forward_columns<S>(s1, mt, qp, dqh, dql, counts);
  }
  restc::store_counts<TU>(counts, nnz, bits, ty, tx);
#pragma unroll
  for (int mt = 0; mt < S::MT; ++mt) {
    int r1[S::NTL][4];
    restc::inverse_columns<S>(dqh, dql, mt, r1);
    restc::inverse_rows<S>(r1, pred, out, mt);
  }
}

// Stages 5-7 for a whole CTU at 8x8 TUs, by all NT threads (K2, B3, B19):
// warp w codes the 16x16 tiles of rows 32 (w >> 2) + 16 s, columns 16 (w &
// 3), s = 0, 1 -- the pixels of the warp's own tiles in the refinement's
// vertical pass (refine_tc_core.cuh tile_y, tile_x), so a caller that wrote
// the prediction from those tiles needs only __syncwarp before this.  The
// two tiles are unrolled: their chains interleave, and within K2's and
// B3's 64 registers this allocates with no spill where a loop (whose
// invariant table words stay live across it) spills.
__device__ __forceinline__ void residual_ctu8(const uint8_t* s_src, const uint8_t* s_pred,
                                              uint8_t* __restrict__ out,
                                              int32_t* __restrict__ nnz,
                                              int32_t* __restrict__ bits, const QParams& qp) {
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int s = 0; s < 2; ++s)
    residual_tile<8>(s_src, s_pred, out, nnz, bits, 2 * (warp >> 2) + s, warp & 3, qp);
}

}  // namespace
