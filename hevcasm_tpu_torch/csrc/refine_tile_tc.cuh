// The quarter-pel refinement of small tiles on the tensor cores, shared by
// B11 (refine_fused.cu) and B12/B13 (costmap.cu) at tile sides S in {8, 16,
// 32}: refine_tc_core.cuh's products, bands, hi/lo planes and score from
// the accumulator fragments, cut to one warp's tile.  (At S = 64 both run
// that core's 64x64 block on a gathered window.)
//
// A warp owns one tile (S = 16, 32) or two side by side (S = 8), with its
// own window and intermediate in shared memory, so a block's warps are
// independent refinements that meet at no barrier.  For a tile or pair:
//
//   1. stage the (S+7)^2 window(s) with rows WS = 48 bytes apart (12 words,
//      so that the 8 rows x 4 words of a B fragment hit 32 banks); at S = 8
//      tile 0 at column 0 and tile 1 at column 16.  Only the window is
//      written: the rest of the HROWS x 48 bytes the products read keeps
//      whatever shared memory held and meets only zero taps;
//   2. horizontal pass, m16n8k32: A = the xf band, B = 32 bytes of a window
//      row; CG m16 groups of 16 output columns x H_NT n8 tiles of rows x 4 xf
//      (S = 16: 1 x 3 x 4 = 12 products).  At S = 8 the band is block-
//      diagonal: outputs 0-7 read inputs 0-14 (tile 0), outputs 8-15 read
//      inputs 16-30 (tile 1), so one product serves both tiles (A registers
//      {w, 0, 0, w}).  The result is hp[xf][col][row], wrapped to int16 and
//      kept as its hi and lo bytes in one column of HS bytes (hi rows at 0,
//      lo rows at LO = HROWS; HS = 48 or 80 bytes, 12 or 20 words, so that a
//      fragment's 8 columns x 4 words hit 32 banks);
//   3. vertical pass, m16n8k16 with the yf band as B (K2's vertical_acc),
//      over the tile's CG x VT fragments of 16 columns x 8 rows, QPEL_SCORE
//      taken from the accumulator, each xf's 4 sums reduced across the warp
//      at once (warp_sums4): lane l keeps cost[(l >> 3) & 3][xf] for the 4
//      xf, one set a tile.
//
// Then B12/B13 write the 16 sums, and B11 takes the first minimum in yf*4 +
// xf order (tile_first_min) and recomputes the winner with one product pair
// a fragment (tile_winner).

#pragma once

#include "refine_tc_core.cuh"

namespace {
namespace rtc {

template <int S>
struct Tile {
  static_assert(S == 8 || S == 16 || S == 32, "sides 8, 16 and 32");
  static constexpr int WIN = S + 7;             // the window a tile reads
  static constexpr int QW = (WIN + 3) / 4;      // words a staged window row
  static constexpr int PER_WARP = S == 8 ? 2 : 1;
  static constexpr int CG = S == 32 ? 2 : 1;    // m16 groups of output columns
  static constexpr int COLS = 16 * CG;          // hp columns a fraction
  static constexpr int VT = S / 8;              // fragments of 8 rows a column group
  static constexpr int FRAGS = CG * VT;         // a lane's accumulator fragments
  static constexpr int H_NT = (WIN + 7) / 8;    // n8 tiles of window rows: 2, 3, 5
  static constexpr int HROWS = 8 * H_NT;        // window rows read, hp rows kept
  static constexpr int WS = 48;                 // window row stride
  static constexpr int HS = 2 * HROWS <= 48 ? 48 : 80;   // hp column stride
  static constexpr int LO = HROWS;              // the lo rows' offset in a column
  static constexpr int WIN_BYTES = HROWS * WS;
  static constexpr int HP_BYTES = 4 * COLS * HS;
  static constexpr int WARP_BYTES = WIN_BYTES + HP_BYTES;   // 3840, 4224, 12160
  static constexpr int PER_BLOCK = NWARPS * PER_WARP;       // tiles a block of NT threads
  static constexpr int SMEM = NWARPS * WARP_BYTES;
  // Blocks an SM that the registers leave room for (__launch_bounds__):
  // four at S <= 16 (34 KB of shared memory a block, 64 registers a
  // thread), two at S = 32 (95 KB).
  static constexpr int MIN_BLOCKS = S == 32 ? 2 : 4;
  static_assert(16 * (CG - 1) + 32 <= WS && (S == 8 ? 16 + WIN : WIN) <= WS,
                "the windows and a B fragment's 32 bytes lie in the row");
  static_assert(2 * HROWS <= HS, "hi and lo rows share a column");
  static_assert(PER_WARP * S * S <= WIN_BYTES, "the predictions reuse the window");
};

// One tile's (S+7)^2 window, rows row_stride bytes apart in device memory
// from w, into the warp's window at `win`, by the 32 lanes.
template <int S>
__device__ __forceinline__ void stage_tile(const uint8_t* __restrict__ w, long long row_stride,
                                           uint8_t* win) {
  using T = Tile<S>;
  for (int k = threadIdx.x & 31; k < T::WIN * T::QW; k += 32) {
    const int r = k / T::QW, q = k - r * T::QW;
    *reinterpret_cast<uint32_t*>(win + r * T::WS + 4 * q) =
        row_word(w + r * row_stride, 4 * q, T::WIN);
  }
}

// Step 2 by the warp: for each (m group, n tile) the window row's 32 bytes
// against the 4 xf bands; lane (g, t) of the product holds columns 16 mt +
// g (registers 0, 1) and + 8 (2, 3) of rows 8 nt + 2t (0, 2) and + 1 (1,
// 3), stored as 16-bit hi and lo pairs.
template <int S>
__device__ __forceinline__ void tile_horizontal(const uint8_t* win, uint8_t* hp) {
  using T = Tile<S>;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  uint32_t a[4][4];
#pragma unroll
  for (int f = 0; f < 4; ++f) {
    a[f][0] = band_lane_word(f);
    a[f][1] = S == 8 ? 0u : band_lane_word(f, -8);
    a[f][2] = 0u;
    a[f][3] = S == 8 ? a[f][0] : band_lane_word(f, 8);
  }
#pragma unroll
  for (int mt = 0; mt < T::CG; ++mt) {
#pragma unroll
    for (int nt = 0; nt < T::H_NT; ++nt) {
      const uint8_t* wr = win + (8 * nt + g) * T::WS + 16 * mt + 4 * t;
      const uint32_t b0 = lds32(wr), b1 = lds32(wr + 16);
#pragma unroll
      for (int xf = 0; xf < 4; ++xf) {
        int d[4] = {0, 0, 0, 0};
        mma_k32_s8u8(d, a[xf], b0, b1);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int off = (xf * T::COLS + 16 * mt + g + 8 * h) * T::HS + 8 * nt + 2 * t;
          const uint32_t v0 = static_cast<uint32_t>(d[2 * h]);
          const uint32_t v1 = static_cast<uint32_t>(d[2 * h + 1]);
          *reinterpret_cast<uint16_t*>(hp + off) = static_cast<uint16_t>(__byte_perm(v0, v1, 0x0051));
          *reinterpret_cast<uint16_t*>(hp + off + T::LO) =
              static_cast<uint16_t>(__byte_perm(v0, v1, 0x0040));
        }
      }
    }
  }
}

// The hi and lo A fragments of fragment f (column group f / VT, rows 8 (f %
// VT) ..) for xf: lane (g, t) reads columns 16 cg + g and + 8, rows 8 j +
// 4t .. + 3.
template <int S>
__device__ __forceinline__ HpFrag tile_fragment(const uint8_t* hp, int xf, int f) {
  using T = Tile<S>;
  const int lane = threadIdx.x & 31;
  const uint8_t* p = hp + (xf * T::COLS + 16 * (f / T::VT) + (lane >> 2)) * T::HS +
                     8 * (f % T::VT) + 4 * (lane & 3);
  return {lds32(p), lds32(p + 8 * T::HS), lds32(p + T::LO), lds32(p + 8 * T::HS + T::LO)};
}

// Register r of fragment f holds the pixel at row 8 (f % VT) + 2t + (r & 1)
// and column 16 (f / VT) + g + 8 (r >> 1) of the tile; at S = 8 column g of
// tile r >> 1.  tile_pixel is its offset in an S x S tile.
template <int S>
__device__ __forceinline__ int tile_pixel(int f, int r) {
  using T = Tile<S>;
  const int lane = threadIdx.x & 31;
  const int y = 8 * (f % T::VT) + 2 * (lane & 3) + (r & 1);
  const int x = S == 8 ? (lane >> 2) : 16 * (f / T::VT) + (lane >> 2) + 8 * (r >> 1);
  return y * S + x;
}

// The source bytes of the lane's pixels, four to a register (byte r of
// src4[f] for register r of fragment f), from the tiles at s0 and (at S =
// 8, registers 2 and 3) s1 in device memory.
template <int S>
__device__ __forceinline__ void tile_source(const uint8_t* __restrict__ s0,
                                            const uint8_t* __restrict__ s1,
                                            uint32_t (&src4)[Tile<S>::FRAGS]) {
#pragma unroll
  for (int f = 0; f < Tile<S>::FRAGS; ++f) {
    src4[f] = 0u;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const uint8_t* s = S == 8 && r >= 2 ? s1 : s0;
      src4[f] |= static_cast<uint32_t>(__ldg(s + tile_pixel<S>(f, r))) << (8 * r);
    }
  }
}

// Step 3 by the warp, one xf at a time: res[p][xf] = the warp's sum of
// QPEL_SCORE of tile p's candidate (yf, xf), yf = (lane >> 3) & 3.
template <int S>
__device__ __forceinline__ void tile_scores(const uint8_t* hp, const uint32_t (&src4)[Tile<S>::FRAGS],
                                            const uint32_t (&w)[4],
                                            int (&res)[Tile<S>::PER_WARP][4]) {
  using T = Tile<S>;
#pragma unroll
  for (int xf = 0; xf < 4; ++xf) {
    int v[T::PER_WARP][4] = {};
#pragma unroll
    for (int f = 0; f < T::FRAGS; ++f) {
      const HpFrag fr = tile_fragment<S>(hp, xf, f);
      int c[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) c[r] = -static_cast<int>(((src4[f] >> (8 * r)) & 0xFFu) << 4);
#pragma unroll
      for (int yf = 0; yf < 4; ++yf) {
        int d[4] = {c[0], c[1], c[2], c[3]};
        vertical_acc(d, w[yf], fr);
        const int lo = (abs(d[0]) >> 4) + (abs(d[1]) >> 4);
        const int hi = (abs(d[2]) >> 4) + (abs(d[3]) >> 4);
        if constexpr (S == 8) {
          v[0][yf] += lo;
          v[1][yf] += hi;
        } else {
          v[0][yf] += lo + hi;
        }
      }
    }
#pragma unroll
    for (int p = 0; p < T::PER_WARP; ++p) res[p][xf] = warp_sums4(v[p]);
  }
}

// Steps 1-3 by the warp for its tiles tile0 .. tile0 + count - 1 (count is
// below PER_WARP only for the last pair at S = 8): stage(i, to) brings tile
// i's window to `to` (tile p's at column 16 p of the warp's window), which
// holds it, visible to the whole warp, until the caller writes there.  w
// receives the band words and res the sums of tile_scores.
template <int S, typename Stage>
__device__ __forceinline__ void tile_sums(const uint8_t* __restrict__ src, int tile0, int count,
                                          uint8_t* win, uint8_t* hp, Stage stage,
                                          uint32_t (&w)[4], int (&res)[Tile<S>::PER_WARP][4]) {
  for (int p = 0; p < count; ++p) stage(tile0 + p, win + 16 * p);
  __syncwarp();
  uint32_t src4[Tile<S>::FRAGS];
  tile_source<S>(src + static_cast<size_t>(tile0) * S * S,
                 src + static_cast<size_t>(tile0 + count - 1) * S * S, src4);
  tile_horizontal<S>(win, hp);
  __syncwarp();
  band_words(w);
  tile_scores<S>(hp, src4, w, res);
}

// The first minimum of a tile's 16 sums in yf*4 + xf order, to every lane,
// with its score in best_cost: lane l offers entry ((l >> 3) & 3) * 4 + (l &
// 3); among the lanes with bit 2 clear, lane order is entry order.
__device__ __forceinline__ int tile_first_min(const int (&res)[4], int& best_cost) {
  constexpr unsigned FULL = 0xffffffffu;
  const int lane = threadIdx.x & 31, xf = lane & 3;
  const int v = xf == 0 ? res[0] : xf == 1 ? res[1] : xf == 2 ? res[2] : res[3];
  best_cost = __reduce_min_sync(FULL, v);
  const int l = __ffs(__ballot_sync(FULL, v == best_cost && !(lane & 4))) - 1;
  return (l >> 3) * 4 + (l & 3);
}

// B11's winners: clip((acc + 2048) >> 12, 0, 255) of tile p's fraction
// best[p] into pred + p * S * S (S x S bytes a tile); the hi product starts
// from 8 = 2048 / 256.  The band and the fragment are chosen by selects and
// the fraction's xf, so the words stay in registers.
template <int S>
__device__ __forceinline__ void tile_winner(const uint8_t* hp, const uint32_t (&w)[4],
                                            const int (&best)[Tile<S>::PER_WARP], uint8_t* pred) {
  using T = Tile<S>;
#pragma unroll
  for (int f = 0; f < T::FRAGS; ++f) {
#pragma unroll
    for (int p = 0; p < T::PER_WARP; ++p) {
      const int yf = best[p] >> 2;
      const uint32_t wy = yf == 0 ? w[0] : yf == 1 ? w[1] : yf == 2 ? w[2] : w[3];
      int d[4] = {8, 8, 8, 8};
      vertical_acc(d, wy, tile_fragment<S>(hp, best[p] & 3, f));
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if (S == 8 && (r >> 1) != p) continue;
        pred[p * S * S + tile_pixel<S>(f, r)] = static_cast<uint8_t>(clip3(0, 255, d[r] >> 12));
      }
    }
  }
}

// A kernel's dynamic shared memory above the 48 KB every kernel may take.
template <typename Kernel>
cudaError_t allow_shared(Kernel kernel, int bytes) {
  return bytes > 48 * 1024
             ? cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes)
             : cudaSuccess;
}

}  // namespace rtc
}  // namespace
