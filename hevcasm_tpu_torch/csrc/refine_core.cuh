// The quarter-pel refinement on the CUDA cores, now serving only B19's
// refinement tail (mega.cu).  K2, B3, B11, B12 and B13 run the tensor-core
// forms (refine_tc_core.cuh, refine_tile_tc.cuh), and B5/B6 theirs
// (mc_tc.cuh).  hevcasm_tpu/kernels/interp_pallas.py _refine_core
// for one BB x BB block (BB in {8, 16, 32, 64}) and its (BB+7) x (BB+7)
// window:
//
//   1. stage the window from device memory (rows row_stride bytes apart);
//   2. 4 horizontal 8-tap passes (one per xf), each wrapped to int16;
//   3. 16 vertical accumulations, scored pixel-parallel by QPEL_SCORE
//      sum |acc - (src << 12)| >> 4 on the pre-clip accumulator and summed
//      by a block reduction; the first minimum in yf*4 + xf order wins.
//
// The 16 candidate planes (256 KB of int32 at BB = 64) do not fit in shared
// memory, so only the four int16 horizontal passes (36 KB) are kept, and
// winner_acc recomputes the winner's accumulator from them.  A block of NTH
// threads gives each thread one column and BB * BB / NTH rows.

#pragma once

#include "residual_core.cuh"

namespace {

// HEVC luma quarter-pel filters, KERNEL8[frac][tap].
__constant__ int K8[4][8] = {
    {0, 0, 0, 64, 0, 0, 0, 0},
    {-1, 4, -10, 58, 17, -5, 1, 0},
    {-1, 4, -11, 40, 40, -11, 4, -1},
    {0, 1, -5, 17, 58, -10, 4, -1},
};

// Shared memory of one refinement of a BB x BB block by NTH threads.
template <int BB, int NTH>
struct RefineSmemT {
  static constexpr int WIN = BB + 7;       // window side
  static constexpr int WSTR = BB + 8;      // window row stride
  static constexpr int ROWS = BB * BB / NTH;  // rows per thread
  static_assert(ROWS >= 1 && NTH % BB == 0, "one column and whole rows a thread");
  __align__(16) uint8_t win[WIN * WSTR];
  __align__(16) int16_t hp[4 * WIN * BB];   // hp[xf][r][c]
  int red[NTH / 32][16];
  int cost[16];
  int best;
};

// B19's refinement: 64x64, NT threads.
using RefineSmem = RefineSmemT<B, NT>;
constexpr int WIN = RefineSmem::WIN;     // 71

// Stages 1-3, run by all NTH threads of the block; w is the window's
// top-left byte in device memory.  s_src (BB, BB) uint8 must be loaded and
// visible to every thread (the window fetch is followed by a barrier).
// Returns the winning fraction yf*4 + xf to every thread; its score is then
// in sm.cost[winner].  sm.win is free again on return, and sm.hp holds the
// horizontal passes until the caller reuses it.
template <int BB, int NTH>
__device__ __forceinline__ int refine_select_at(const uint8_t* __restrict__ w,
                                                size_t row_stride,
                                                const uint8_t* s_src,
                                                RefineSmemT<BB, NTH>& sm) {
  using S = RefineSmemT<BB, NTH>;
  constexpr int ROWS = S::ROWS;
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;

  // ---- 1. window ----------------------------------------------------------
  for (int k = t; k < S::WIN * S::WIN; k += NTH) {
    const int r = k / S::WIN, c = k - r * S::WIN;
    sm.win[r * S::WSTR + c] = w[r * row_stride + c];
  }
  __syncthreads();

  // ---- 2. horizontal passes: hp[xf][r][c], int16-wrapped ------------------
  for (int k = t; k < 4 * S::WIN * BB; k += NTH) {
    const int xf = k / (S::WIN * BB);
    const int rem = k - xf * S::WIN * BB;
    const int r = rem / BB, c = rem - r * BB;
    const uint8_t* wr = sm.win + r * S::WSTR + c;
    int v = 0;
#pragma unroll
    for (int tap = 0; tap < 8; ++tap) v += K8[xf][tap] * wr[tap];
    sm.hp[k] = static_cast<int16_t>(wrap16(v));
  }
  __syncthreads();

  // ---- 3. vertical accumulations + QPEL_SCORE -----------------------------
  // Thread t owns column x and the ROWS rows [ROWS*yg, ROWS*yg + ROWS).
  const int x = t % BB, yg = t / BB;
  int cost[16];
#pragma unroll
  for (int c = 0; c < 16; ++c) cost[c] = 0;
#pragma unroll
  for (int xf = 0; xf < 4; ++xf) {
    int col[ROWS + 7];
    const int16_t* hp = sm.hp + (xf * S::WIN + ROWS * yg) * BB + x;
#pragma unroll
    for (int r = 0; r < ROWS + 7; ++r) col[r] = hp[r * BB];
#pragma unroll
    for (int yy = 0; yy < ROWS; ++yy) {
      const int s12 = static_cast<int>(s_src[(ROWS * yg + yy) * BB + x]) << 12;
#pragma unroll
      for (int yf = 0; yf < 4; ++yf) {
        int acc = 0;
#pragma unroll
        for (int tap = 0; tap < 8; ++tap) acc += K8[yf][tap] * col[yy + tap];
        cost[yf * 4 + xf] += abs(acc - s12) >> 4;
      }
    }
  }
#pragma unroll
  for (int c = 0; c < 16; ++c) {
    int v = cost[c];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) sm.red[warp][c] = v;
  }
  __syncthreads();
  if (t < 16) {
    int v = 0;
#pragma unroll
    for (int wi = 0; wi < NTH / 32; ++wi) v += sm.red[wi][t];
    sm.cost[t] = v;
  }
  __syncthreads();
  if (t == 0) {
    // First minimum: the minimum value, then the smallest index holding it.
    int best = sm.cost[0];
    for (int c = 1; c < 16; ++c) best = min(best, sm.cost[c]);
    int idx = 0;
    while (sm.cost[idx] != best) ++idx;
    sm.best = idx;
  }
  __syncthreads();
  return sm.best;
}

// B19's form: the 71x71 window at (oy, ox) in the plane,
// a start past the plane's end clamped so the window fits.
__device__ __forceinline__ int refine_select(const uint8_t* __restrict__ plane,
                                             int plane_h, int plane_w, int oy,
                                             int ox, const uint8_t* s_src,
                                             RefineSmem& sm) {
  const int y0 = clip3(0, plane_h - WIN, oy);
  const int x0 = clip3(0, plane_w - WIN, ox);
  return refine_select_at<B, NT>(plane + static_cast<size_t>(y0) * plane_w + x0,
                                 plane_w, s_src, sm);
}

// The pre-clip accumulator of candidate `frac` at column x, row
// ROWS * yg + yy, recomputed from the horizontal passes.
template <int BB, int NTH>
__device__ __forceinline__ int winner_acc(const RefineSmemT<BB, NTH>& sm, int frac,
                                          int x, int yg, int yy) {
  using S = RefineSmemT<BB, NTH>;
  const int yf = frac >> 2, xf = frac & 3;
  const int16_t* hp = sm.hp + (xf * S::WIN + S::ROWS * yg + yy) * BB + x;
  int acc = 0;
#pragma unroll
  for (int tap = 0; tap < 8; ++tap) acc += K8[yf][tap] * hp[tap * BB];
  return acc;
}

}  // namespace
