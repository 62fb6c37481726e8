// The quarter-pel refinement of a 64x64 CTU on the tensor cores, shared by
// K2 (inter_fused.cu, which B16 also launches) and B3 (bi_fused.cu):
// hevcasm_tpu/kernels/interp_pallas.py _refine_core, which runs both FIR
// passes as matrix products, carried over to Hopper's mma.sync with u8 and
// s8 operands and exact s32 sums.  B11 (refine_fused.cu) and B12
// (costmap.cu) run it at side 64 on a gathered window (stage_gathered,
// scores_gathered); their smaller tiles take its products, bands and score
// in refine_tile_tc.cuh.
//
// Both passes multiply by the filter's band, band[o][k] = K8[f][k - o] for
// 0 <= k - o < 8, else 0: 16 outputs read 23 consecutive inputs, 8 outputs
// 15.  Lane (g, t)'s word of taps 4t - g .. 4t - g + 3 is the same in both
// passes (band_word).
//
//   1. stage the window: 72 rows of 80 bytes (the m16 tiles of the
//      horizontal pass read 32 columns from 16 mt, so up to 79; rows and
//      columns 71..79 meet only zero taps), read from within the plane
//      (rows and columns past it clamped);
//   2. horizontal pass, m16n8k32: A = the xf band (s8, 16 output columns x
//      32 inputs), B = 32 consecutive bytes of a window row (u8); 4 m tiles
//      of columns x 9 n tiles of rows x 4 xf.  The s32 result is the
//      intermediate transposed, hp[xf][col][row], wrapped to int16 (its two
//      low bytes) and kept as two byte planes, hi = v >> 8 (s8, in [-24,
//      87]) and lo = v & 255 (u8);
//   3. vertical pass, m16n8k16: A = hp hi or lo (16 columns x 16 rows, rows
//      contiguous for each column), B = the yf band (16 rows x 8 outputs:
//      one register), acc = 256 (hi band) + lo band with .s8.s8 and .u8.s8
//      (no centring).  Warp w owns 16 columns x 32 rows (4 tiles of 8
//      rows); for each tile and xf it loads the hi and lo fragments once and
//      runs the 4 yf bands over them.  QPEL_SCORE sum |acc - (src << 12)| >>
//      4 is taken in the accumulator fragments: the hi product starts from
//      -(src << 4), so that after the shift by 8 and the lo product the
//      fragment holds acc - (src << 12);
//   4. each xf's 4 sums are reduced across the warp (a reduce-scatter to
//      lanes by yf, then a butterfly), so a lane keeps 4 sums live, not
//      16; then across the 8 warps through shared memory; every warp takes
//      the first minimum in yf*4 + xf order itself (min, then the lowest
//      lane holding it);
//   5. the caller recomputes the winner's accumulator with one more
//      product pair a tile (winner_acc) in the same lane layout.
//
// No candidate plane is ever stored: the 16 candidates of a pixel exist only
// in accumulator registers.

#pragma once

#include "residual_core.cuh"
#include "ssd_tc_core.cuh"

namespace {
namespace rtc {

constexpr int WIN = B + 7;                 // 71: the window the refinement reads
constexpr int ROWS = 72;                   // window rows staged, hp rows kept
constexpr int WS = 80;                     // window row stride and hp column stride:
                                           // 20 words, so a fragment's 8 rows (columns)
                                           // x 4 words hit 32 banks
constexpr int HP_PLANE = 4 * B * WS;       // one byte plane of hp[xf][col][row]
constexpr int HP_BYTES = 2 * HP_PLANE;     // hi and lo: 40960
constexpr int WIN_BYTES = ROWS * WS;       // 5760
constexpr int NWARPS = NT / 32;            // 8
constexpr int MT = B / 16;                 // 4 m16 tiles of output columns
constexpr int H_NT = ROWS / 8;             // 9 n8 tiles of window rows
constexpr int TILES = 4;                   // a warp's vertical tiles of 16 x 8
static_assert(NWARPS * TILES * 16 * 8 == B * B, "the warps' vertical tiles cover the CTU");
static_assert(B * B <= WIN_BYTES, "the prediction reuses the window");

// Shared memory of a block: hp, the window, the source and the per-warp
// sums (the residual stage needs none).
constexpr int SM_HP = 0;
constexpr int SM_WIN = SM_HP + HP_BYTES;
constexpr int SM_SRC = SM_WIN + WIN_BYTES;
constexpr int SM_RED = SM_SRC + B * B;
constexpr int SMEM = SM_RED + NWARPS * 16 * 4;    // 51328: four blocks an SM

struct Smem {
  uint8_t* hp;
  uint8_t* win;
  uint8_t* src;
  int* red;
};

__device__ __forceinline__ Smem carve(uint8_t* smem) {
  return {smem + SM_HP, smem + SM_WIN, smem + SM_SRC, reinterpret_cast<int*>(smem + SM_RED)};
}

// KERNEL8[f] as 8 signed bytes, tap 0 in the low byte.
__device__ __forceinline__ uint64_t k8_bytes(int f) {
  return f == 0 ? 0x0000000040000000ull
       : f == 1 ? 0x0001FB113AF604FFull
       : f == 2 ? 0xFF04F52828F504FFull
                : 0xFF04F63A11FB0100ull;
}

// Taps first .. first + 3 of a filter, as one word of s8 bytes, 0 outside
// 0..7.
__device__ __forceinline__ uint32_t band_word(uint64_t taps, int first) {
  if (first >= 8 || first <= -4) return 0u;
  return first >= 0 ? static_cast<uint32_t>(taps >> (8 * first))
                    : static_cast<uint32_t>(taps << (-8 * first));
}

// Lane (g, t)'s word of band f: taps 4t - g .. 4t - g + 3.
__device__ __forceinline__ uint32_t band_lane_word(int f, int first_offset = 0) {
  const int lane = threadIdx.x & 31;
  return band_word(k8_bytes(f), 4 * (lane & 3) - (lane >> 2) + first_offset);
}

// w[f]: the vertical pass's B fragment of band f (m16n8k16, one register:
// rows k = 4t .. 4t + 3 of output column g).
__device__ __forceinline__ void band_words(uint32_t (&w)[4]) {
#pragma unroll
  for (int f = 0; f < 4; ++f) w[f] = band_lane_word(f);
}

// d += a (16x32 s8, row) * b (32x8 u8, col), s32: the horizontal pass.
__device__ __forceinline__ void mma_k32_s8u8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a (16x16 s8 or u8, row) * b (16x8 s8, col), s32: the vertical pass
// on the hi and the lo plane.
__device__ __forceinline__ void mma_k16_s8s8(int (&d)[4], uint32_t a0, uint32_t a1,
                                             uint32_t b) {
  asm("mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(b));
}

__device__ __forceinline__ void mma_k16_u8s8(int (&d)[4], uint32_t a0, uint32_t a1,
                                             uint32_t b) {
  asm("mma.sync.aligned.m16n8k16.row.col.s32.u8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(b));
}

// The CTU's 64 rows of 64 bytes in device memory (any alignment) into
// shared memory, by all NT threads.
__device__ __forceinline__ void stage_source(const uint8_t* __restrict__ s, uint8_t* s_src) {
  for (int k = threadIdx.x; k < B * B / 4; k += NT)
    reinterpret_cast<uint32_t*>(s_src)[k] = hevc_tc::load_word(s + 4 * k);
}

// The 80 x 80 window whose 71 x 71 corner starts at (oy, ox), a start past
// the plane's end clamped so that the 71 x 71 fits (the plain version's
// gather); rows and columns 71..79 are read from within the plane (clamped
// to its last row and column), by all NT threads.
__device__ __forceinline__ void stage_window(const uint8_t* __restrict__ plane, int plane_h,
                                             int plane_w, int oy, int ox, uint8_t* win) {
  const int y0 = clip3(0, plane_h - WIN, oy);
  const int x0 = clip3(0, plane_w - WIN, ox);
  constexpr int WORDS = WS / 4;
  for (int k = threadIdx.x; k < ROWS * WORDS; k += NT) {
    const int r = k / WORDS, q = k - r * WORDS;
    const uint8_t* row = plane + static_cast<size_t>(min(y0 + r, plane_h - 1)) * plane_w;
    const int c = x0 + 4 * q;
    uint32_t v;
    if (c + 3 < plane_w) {
      v = hevc_tc::load_word(row + c);
    } else {
      v = 0u;
#pragma unroll
      for (int b = 0; b < 4; ++b) v |= static_cast<uint32_t>(row[min(c + b, plane_w - 1)]) << (8 * b);
    }
    *reinterpret_cast<uint32_t*>(win + r * WS + 4 * q) = v;
  }
}

// Words of a window row of w bytes: the last one, short of the row's end,
// is read byte by byte, the others as the aligned words that hold their
// bytes (each holds a byte of the row), so no read leaves the row.
__device__ __forceinline__ uint32_t row_word(const uint8_t* __restrict__ row, int c, int w) {
  if (c + 4 <= w) return hevc_tc::load_word(row + c);
  uint32_t v = 0u;
#pragma unroll
  for (int b = 0; b < 4; ++b)
    if (c + b < w) v |= static_cast<uint32_t>(__ldg(row + c + b)) << (8 * b);
  return v;
}

// B11's and B12's form of stage_window for a gathered window (rows
// row_stride bytes apart, w its top-left byte): only the 71 x 71 corner is
// read and staged, by all NT threads; the rows and columns 71..79 that the
// products also read keep whatever shared memory held, and meet only zero
// taps.
__device__ __forceinline__ void stage_gathered(const uint8_t* __restrict__ w,
                                               long long row_stride, uint8_t* win) {
  constexpr int WORDS = (WIN + 3) / 4;
  for (int k = threadIdx.x; k < WIN * WORDS; k += NT) {
    const int r = k / WORDS, q = k - r * WORDS;
    *reinterpret_cast<uint32_t*>(win + r * WS + 4 * q) = row_word(w + r * row_stride, 4 * q, WIN);
  }
}

// Step 2, by all warps: the 36 (m tile, n tile) pairs, each multiplied by
// the 4 xf bands.  The A fragment of band xf: register 0 holds output
// column g, inputs 4t .. 4t + 3 (the vertical pass's word); 1 column
// g + 8, the same inputs; 2 column g, inputs 16 + 4t .. (always 0: k - o
// >= 9); 3 column g + 8, those.  Lane (g, t) of the product holds columns
// c = 16 mt + g (registers 0, 1) and c + 8 (2, 3) of window rows r = 8 nt +
// 2t (0, 2) and r + 1 (1, 3); the int16 wrap keeps the two low bytes, which
// go to the hi and lo planes as one 16-bit store each.
__device__ __forceinline__ void horizontal_pass(const uint8_t* win, uint8_t* hp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  uint32_t a[4][4];
#pragma unroll
  for (int f = 0; f < 4; ++f) {
    a[f][0] = band_lane_word(f);
    a[f][1] = band_lane_word(f, -8);
    a[f][2] = 0u;
    a[f][3] = band_lane_word(f, 8);
  }
  for (int p = warp; p < MT * H_NT; p += NWARPS) {
    const int mt = p % MT, nt = p / MT;
    const uint8_t* wr = win + (8 * nt + g) * WS + 16 * mt + 4 * t;
    const uint32_t b0 = lds32(wr), b1 = lds32(wr + 16);
#pragma unroll
    for (int xf = 0; xf < 4; ++xf) {
      int d[4] = {0, 0, 0, 0};
      mma_k32_s8u8(d, a[xf], b0, b1);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int off = (xf * B + 16 * mt + g + 8 * h) * WS + 8 * nt + 2 * t;
        const uint32_t v0 = static_cast<uint32_t>(d[2 * h]);
        const uint32_t v1 = static_cast<uint32_t>(d[2 * h + 1]);
        *reinterpret_cast<uint16_t*>(hp + off) = static_cast<uint16_t>(__byte_perm(v0, v1, 0x0051));
        *reinterpret_cast<uint16_t*>(hp + HP_PLANE + off) =
            static_cast<uint16_t>(__byte_perm(v0, v1, 0x0040));
      }
    }
  }
}

// The vertical pass's tiles: warp w's tile j covers columns x0 = 16 (w & 3)
// .. + 15 and rows y0 = 32 (w >> 2) + 8j .. + 7; lane (g, t)'s accumulator
// register r holds pixel (y0 + 2t + (r & 1), x0 + g + 8 (r >> 1)).
__device__ __forceinline__ int tile_y(int j, int r) {
  return 32 * (threadIdx.x >> 7) + 8 * j + 2 * (threadIdx.x & 3) + (r & 1);
}
__device__ __forceinline__ int tile_x(int r) {
  return 16 * ((threadIdx.x >> 5) & 3) + ((threadIdx.x & 31) >> 2) + 8 * (r >> 1);
}

// The hi and lo A fragments of the warp's tile j for xf: lane (g, t) reads
// columns x0 + g and x0 + g + 8, rows y0 + 4t .. + 3 of each plane.
struct HpFrag {
  uint32_t h0, h1, l0, l1;
};

__device__ __forceinline__ HpFrag hp_fragment(const uint8_t* hp, int xf, int j) {
  const int y0 = 32 * (threadIdx.x >> 7) + 8 * j;
  const uint8_t* p = hp + (xf * B + tile_x(0)) * WS + y0 + 4 * (threadIdx.x & 3);
  return {lds32(p), lds32(p + 8 * WS), lds32(p + HP_PLANE), lds32(p + HP_PLANE + 8 * WS)};
}

// d = c + acc: the vertical accumulator of band word w over the fragment
// f, plus c (which the hi product carries at 1/256 of its weight).
__device__ __forceinline__ void vertical_acc(int (&d)[4], uint32_t w, const HpFrag& f) {
  mma_k16_s8s8(d, f.h0, f.h1, w);
#pragma unroll
  for (int j = 0; j < 4; ++j) d[j] *= 256;
  mma_k16_u8s8(d, f.l0, f.l1, w);
}

// The warp's sums of the 4 candidates v[yf] of one xf: a reduce-scatter
// at offsets 16 and 8 (a lane keeps the half its bit selects and adds its
// partner's of that half), then a sum over offsets 4, 2 and 1; lane l ends
// with the warp sum of yf = (l >> 3) & 3.
__device__ __forceinline__ int warp_sums4(const int (&v)[4]) {
  constexpr unsigned FULL = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const bool up16 = lane & 16, up8 = lane & 8;
  const int p0 = (up16 ? v[2] : v[0]) + __shfl_xor_sync(FULL, up16 ? v[0] : v[2], 16);
  const int p1 = (up16 ? v[3] : v[1]) + __shfl_xor_sync(FULL, up16 ? v[1] : v[3], 16);
  int r = (up8 ? p1 : p0) + __shfl_xor_sync(FULL, up8 ? p0 : p1, 8);
  r += __shfl_xor_sync(FULL, r, 4);
  r += __shfl_xor_sync(FULL, r, 2);
  return r + __shfl_xor_sync(FULL, r, 1);
}

// Step 3, by each warp over its 4 tiles, one xf at a time (so that 4 sums,
// not 16, are live): QPEL_SCORE of the 16 candidates over the warp's
// pixels, into s_red[warp * 16 + yf * 4 + xf].  The source bytes of the
// lane's 16 pixels are loaded once, four to a register (byte r of src4[j]
// for register r of tile j), so that B3 holds its first reference's
// prediction beside them without spilling.
__device__ __forceinline__ void vertical_scores(const uint8_t* hp, const uint8_t* s_src,
                                                const uint32_t (&w)[4], int* s_red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t src4[TILES];
#pragma unroll
  for (int j = 0; j < TILES; ++j) {
    src4[j] = 0u;
#pragma unroll
    for (int r = 0; r < 4; ++r)
      src4[j] |= static_cast<uint32_t>(s_src[tile_y(j, r) * B + tile_x(r)]) << (8 * r);
  }
#pragma unroll
  for (int xf = 0; xf < 4; ++xf) {
    int v[4] = {0, 0, 0, 0};
#pragma unroll
    for (int j = 0; j < TILES; ++j) {
      const HpFrag f = hp_fragment(hp, xf, j);
      int c[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) c[r] = -static_cast<int>(((src4[j] >> (8 * r)) & 0xFFu) << 4);
#pragma unroll
      for (int yf = 0; yf < 4; ++yf) {
        int d[4] = {c[0], c[1], c[2], c[3]};
        vertical_acc(d, w[yf], f);
        v[yf] += (abs(d[0]) >> 4) + (abs(d[1]) >> 4) + (abs(d[2]) >> 4) + (abs(d[3]) >> 4);
      }
    }
    const int r = warp_sums4(v);
    if (!(lane & 7)) s_red[warp * 16 + (lane >> 3) * 4 + xf] = r;
  }
}

// Step 4: the block's sums of the 16 candidates and the first minimum in
// yf*4 + xf order, returned to every thread with its score in best_cost.
// Its barrier makes every warp's s_red entries visible; each warp then
// takes the minimum itself (the lowest lane holding it).
__device__ __forceinline__ int first_min(const int* s_red, int& best_cost) {
  constexpr unsigned FULL = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  __syncthreads();
  int total = 0x7fffffff;
  if (lane < 16) {
    total = 0;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) total += s_red[w * 16 + lane];
  }
  best_cost = __reduce_min_sync(FULL, total);
  return __ffs(__ballot_sync(FULL, total == best_cost)) - 1;
}

// Step 5: the winner's accumulator plus 256 c0 for the warp's tile j, in
// the lane layout of vertical_scores.  The band is chosen by selects, so
// the words stay in registers.
__device__ __forceinline__ void winner_acc(int (&d)[4], const uint8_t* hp,
                                           const uint32_t (&w)[4], int best, int j, int c0) {
  const int yf = best >> 2;
  const uint32_t wy = yf == 0 ? w[0] : yf == 1 ? w[1] : yf == 2 ? w[2] : w[3];
#pragma unroll
  for (int r = 0; r < 4; ++r) d[r] = c0;
  vertical_acc(d, wy, hp_fragment(hp, best & 3, j));
}

// Steps 1-4 for one reference, by all NT threads: the window at (oy, ox)
// of the plane, with s_src already staged (visible after the window's
// barrier).  Returns the winning fraction yf*4 + xf and its score to every
// thread; hp then holds the winner's planes until the caller's next
// barrier.
__device__ __forceinline__ int refine(const uint8_t* __restrict__ plane, int plane_h,
                                      int plane_w, int oy, int ox, const Smem& sm,
                                      const uint32_t (&w)[4], int& best_cost) {
  stage_window(plane, plane_h, plane_w, oy, ox, sm.win);
  __syncthreads();
  horizontal_pass(sm.win, sm.hp);
  __syncthreads();
  vertical_scores(sm.hp, sm.src, w, sm.red);
  return first_min(sm.red, best_cost);
}

// Steps 1-3 on a gathered window (B11 and B12 at 64), by all NT threads,
// with s_src already staged: each warp's 16 sums are in s_red, visible
// after the caller's next barrier; hp holds the intermediate.
__device__ __forceinline__ void scores_gathered(const uint8_t* __restrict__ win, long long row_stride,
                                                const Smem& sm, const uint32_t (&w)[4]) {
  stage_gathered(win, row_stride, sm.win);
  __syncthreads();
  horizontal_pass(sm.win, sm.hp);
  __syncthreads();
  vertical_scores(sm.hp, sm.src, w, sm.red);
}

}  // namespace rtc

// The five quantizer parameters (residual_core.cuh QParams) as a device
// int32[5] in that order, with a range flag: the source of the parameters in
// K2's and B3's device-q C entries, whose caller keeps qp on the card.
struct DevQParams {
  const int32_t* qvec;
  int32_t* range_flag;
};

// Each parameter outside the range the host entries check sets its bit
// (ops/quantize.py QUANT_RANGES): 1 scale (1..2^15-1), 2 shift (16..27),
// 4 offset (0..2^15-1), 8 dshift (1..31).
__device__ __forceinline__ int qparams_range_bits(const QParams& p) {
  return static_cast<int>(p.qscale < 1 || p.qscale > 0x7FFF) |
         static_cast<int>(p.qshift < 16 || p.qshift > 27) << 1 |
         static_cast<int>(p.qoffset < 0 || p.qoffset > 0x7FFF) << 2 |
         static_cast<int>(p.dshift < 1 || p.dshift > 31) << 3;
}

// Where K2's and B3's kernels take the parameters from, by the type of
// their source: prefetch_qparams at the kernel's start, qparams_ok after the
// refinement (false: the block must code nothing), qparams for the residual
// stage.  Host ints are the kernel's by-value parameter, checked by the C
// entry before the launch.
__device__ __forceinline__ void prefetch_qparams(const QParams&) {}
__device__ __forceinline__ bool qparams_ok(const QParams&) { return true; }
__device__ __forceinline__ const QParams& qparams(const QParams& src) { return src; }

// The block's shared copy of a device vector.
__device__ __forceinline__ QParams* qparams_smem() {
  __shared__ QParams s_qp;
  return &s_qp;
}

// A device vector: five lanes copy it to shared memory as the kernel starts,
// so the load's latency hides behind the refinement, whose barriers publish
// the copy.  Out of range, one lane ORs the parameters' bits into the flag
// and the block writes nothing computed with them.
__device__ __forceinline__ void prefetch_qparams(const DevQParams& src) {
  if (threadIdx.x < 5)
    reinterpret_cast<int*>(qparams_smem())[threadIdx.x] = __ldg(src.qvec + threadIdx.x);
}
__device__ __forceinline__ bool qparams_ok(const DevQParams& src) {
  const int bad = qparams_range_bits(*qparams_smem());
  if (bad && threadIdx.x == 0) atomicOr(src.range_flag, bad);
  return !bad;
}
__device__ __forceinline__ const QParams& qparams(const DevQParams&) { return *qparams_smem(); }

}  // namespace
