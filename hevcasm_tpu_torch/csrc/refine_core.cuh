// The quarter-pel refinement shared by the fused CTU kernels (K2
// inter_fused.cu, B3 bi_fused.cu): hevcasm_tpu/kernels/interp_pallas.py
// _refine_core for one 64x64 CTU whose window is read from the plane.
//
//   1. fetch the 71x71 window at (oy, ox) straight from the plane (a start
//      past the plane's end is clamped so the window fits);
//   2. 4 horizontal 8-tap passes (one per xf), each wrapped to int16;
//   3. 16 vertical accumulations, scored pixel-parallel by QPEL_SCORE
//      sum |acc - (src << 12)| >> 4 on the pre-clip accumulator and summed
//      by a block reduction; the first minimum in yf*4 + xf order wins.
//
// The 16 candidate planes (256 KB of int32) do not fit in shared memory,
// so only the four int16 horizontal passes (36 KB) are kept, and
// winner_acc recomputes the winner's accumulator from them.

#pragma once

#include "residual_core.cuh"

namespace {

constexpr int WIN = B + 7;      // refine window: 71 x 71
constexpr int WSTR = 72;        // window row stride in shared memory
constexpr int NWARP = NT / 32;

// HEVC luma quarter-pel filters, KERNEL8[frac][tap].
__constant__ int K8[4][8] = {
    {0, 0, 0, 64, 0, 0, 0, 0},
    {-1, 4, -10, 58, 17, -5, 1, 0},
    {-1, 4, -11, 40, 40, -11, 4, -1},
    {0, 1, -5, 17, 58, -10, 4, -1},
};

// Shared memory of one refinement.
struct RefineSmem {
  __align__(16) uint8_t win[WIN * WSTR];
  __align__(16) int16_t hp[4 * WIN * B];   // hp[xf][r][c]
  int red[NWARP][16];
  int cost[16];
  int best;
};

// Stages 1-3, run by all NT threads of the block; s_src (B, B) uint8 must
// be loaded and visible to every thread (the window fetch is followed by a
// barrier).  Returns the winning fraction yf*4 + xf to every thread; its
// score is then in sm.cost[winner].  sm.win is free again on return, and
// sm.hp holds the horizontal passes until the caller reuses it.
__device__ __forceinline__ int refine_select(const uint8_t* __restrict__ plane,
                                             int plane_h, int plane_w, int oy,
                                             int ox, const uint8_t* s_src,
                                             RefineSmem& sm) {
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;

  // ---- 1. window ----------------------------------------------------------
  const int y0 = clip3(0, plane_h - WIN, oy);
  const int x0 = clip3(0, plane_w - WIN, ox);
  for (int k = t; k < WIN * WIN; k += NT) {
    const int r = k / WIN, c = k - r * WIN;
    sm.win[r * WSTR + c] = plane[static_cast<size_t>(y0 + r) * plane_w + x0 + c];
  }
  __syncthreads();

  // ---- 2. horizontal passes: hp[xf][r][c], int16-wrapped ------------------
  for (int k = t; k < 4 * WIN * B; k += NT) {
    const int xf = k / (WIN * B);
    const int rem = k - xf * WIN * B;
    const int r = rem / B, c = rem - r * B;
    const uint8_t* w = sm.win + r * WSTR + c;
    int v = 0;
#pragma unroll
    for (int tap = 0; tap < 8; ++tap) v += K8[xf][tap] * w[tap];
    sm.hp[k] = static_cast<int16_t>(wrap16(v));
  }
  __syncthreads();

  // ---- 3. vertical accumulations + QPEL_SCORE -----------------------------
  // Thread t owns column x and the 16 rows [16*yg, 16*yg + 16).
  const int x = t % B, yg = t / B;
  int cost[16];
#pragma unroll
  for (int c = 0; c < 16; ++c) cost[c] = 0;
#pragma unroll
  for (int xf = 0; xf < 4; ++xf) {
    int col[16 + 7];
    const int16_t* hp = sm.hp + (xf * WIN + 16 * yg) * B + x;
#pragma unroll
    for (int r = 0; r < 16 + 7; ++r) col[r] = hp[r * B];
#pragma unroll
    for (int yy = 0; yy < 16; ++yy) {
      const int s12 = static_cast<int>(s_src[(16 * yg + yy) * B + x]) << 12;
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
    for (int w = 0; w < NWARP; ++w) v += sm.red[w][t];
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

// The pre-clip accumulator of candidate `frac` at column x, row
// 16 * yg + yy, recomputed from the horizontal passes.
__device__ __forceinline__ int winner_acc(const RefineSmem& sm, int frac, int x,
                                          int yg, int yy) {
  const int yf = frac >> 2, xf = frac & 3;
  const int16_t* hp = sm.hp + (xf * WIN + 16 * yg + yy) * B + x;
  int acc = 0;
#pragma unroll
  for (int tap = 0; tap < 8; ++tap) acc += K8[yf][tap] * hp[tap * B];
  return acc;
}

}  // namespace
