// The exact SSD grid core of B8 (csrc/ssd_grid.cu) and B14
// (csrc/base_grids.cu), on the CUDA cores.
//
// Block i is a SIDE x SIDE source block (SIDE in {8, ..., 64}) split into
// K x K sub-blocks of side BASE (K = SIDE / BASE; B8 runs K = 1).  For
// every displacement (dy, dx) in [0, num_dy) x [0, num_dx) of its window:
//
//   grids[i][p][q][dy][dx] = sum_{y,x < BASE} (win[i][BASE*p + dy + y][BASE*q + dx + x]
//                                              - src[i][BASE*p + y][BASE*q + x])^2
//
// in exact int32 (a 64 x 64 sum is below 4096 * 255^2 < 2^31).
//
// Design, the CUDA-core loop K1 ran before its tensor-core form (csrc/
// ssd_tc_core.cuh): one block per (source block, slice of dy rows) stages
// the source block and the window rows its slice needs in shared memory;
// each thread owns one dy and DXT = 8 consecutive dx and slides 4-byte
// window words over them in registers, one shared load feeding 32
// subtract-multiply-adds.  A thread keeps one sum per sub-block column
// (K x DXT registers) and, after every BASE rows, writes the finished row
// of sub-blocks.  Window bytes past the window's width or height stage as
// zero; they reach only candidates past num_dx, which are never written.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace hevc_grid {

constexpr int DXT = 8;              // dx per thread
constexpr int MAX_DY = 16;          // dy rows per block
constexpr int MAX_THREADS = 256;
constexpr size_t MAX_SMEM = 48 * 1024;

__device__ __forceinline__ int byte_of(uint32_t w, int i) {
  return static_cast<int>((w >> (8 * i)) & 0xFFu);
}

// Staged window row stride in bytes.  A thread reads bytes [dx0, dx0 + SIDE
// + 8) of a row, so rows hold DXT * groups + SIDE bytes; an odd word count
// spreads the rows of one warp over the banks (140 for SIDE 64, R = 32).
inline int staged_width(int side, int num_dx) {
  const int groups = (num_dx + DXT - 1) / DXT;
  int ws = DXT * groups + side;                     // a multiple of 4
  if ((ws / 4) % 2 == 0) ws += 4;
  return ws;
}

// WS > 0 fixes the staged row stride at compile time (B14/B15: 140 bytes,
// every R <= 32); WS = 0 takes it from ws_arg.  With the stride at run time
// ptxas kept 104 registers instead of 128 at BASE 8 and B14 took 1.17
// against 1.03 ms a 1920x1088 frame on an H100 (700 W).
template <int SIDE, int BASE, int WS>
__global__ void __launch_bounds__(MAX_THREADS)
grid_kernel(const uint8_t* __restrict__ src, const uint8_t* __restrict__ windows,
            int win_stride, int row_stride, int win_h, int win_w, int num_dy, int num_dx,
            int dy_per_block, int ws_arg, int32_t* __restrict__ grids) {
  constexpr int K = SIDE / BASE;
  const int ws = WS > 0 ? WS : ws_arg;
  extern __shared__ __align__(16) uint8_t s_grid[];
  uint8_t* s_src = s_grid;                           // SIDE * SIDE
  uint8_t* s_win = s_grid + SIDE * SIDE;             // (rows + SIDE - 1) * ws

  const int groups = (num_dx + DXT - 1) / DXT;
  const int blk = blockIdx.x;
  const int dy0 = blockIdx.y * dy_per_block;
  const int rows = min(dy_per_block, num_dy - dy0);
  const int wrows = rows + SIDE - 1;
  const int t = threadIdx.x;

  const uint8_t* s = src + static_cast<size_t>(blk) * SIDE * SIDE;
  for (int i = t; i < SIDE * SIDE; i += blockDim.x) s_src[i] = s[i];
  const uint8_t* w = windows + static_cast<size_t>(blk) * win_stride
                     + static_cast<size_t>(dy0) * row_stride;
  for (int i = t; i < wrows * ws; i += blockDim.x) {
    const int y = i / ws, x = i - y * ws;
    uint8_t v = 0;
    if (x < win_w && dy0 + y < win_h) v = w[static_cast<size_t>(y) * row_stride + x];
    s_win[i] = v;
  }
  __syncthreads();

  const int g = t % groups;
  const int dyl = t / groups;
  if (dyl >= rows) return;
  const int dx0 = g * DXT;
  for (int p = 0; p < K; ++p) {
    int acc[K][DXT];
#pragma unroll
    for (int q = 0; q < K; ++q)
#pragma unroll
      for (int kk = 0; kk < DXT; ++kk) acc[q][kk] = 0;
    for (int yy = 0; yy < BASE; ++yy) {
      const int y = p * BASE + yy;
      const uint32_t* wrow =
          reinterpret_cast<const uint32_t*>(s_win + (dyl + y) * ws + dx0);
      const uint32_t* srow = reinterpret_cast<const uint32_t*>(s_src + y * SIDE);
      uint32_t w0 = wrow[0], w1 = wrow[1];
#pragma unroll
      for (int xb = 0; xb < SIDE / 4; ++xb) {
        constexpr int WORDS = BASE / 4;      // source words per sub-block row
        const int q = xb / WORDS;            // known once unrolled
        const uint32_t w2 = wrow[xb + 2];
        const uint32_t sw = srow[xb];
        int wv[12];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          wv[i] = byte_of(w0, i);
          wv[4 + i] = byte_of(w1, i);
          wv[8 + i] = byte_of(w2, i);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int sv = byte_of(sw, i);
#pragma unroll
          for (int kk = 0; kk < DXT; ++kk) {
            const int d = wv[i + kk] - sv;
            acc[q][kk] += d * d;
          }
        }
        w0 = w1;
        w1 = w2;
      }
    }
#pragma unroll
    for (int q = 0; q < K; ++q) {
      int32_t* o = grids + ((static_cast<size_t>(blk) * K * K + p * K + q) * num_dy
                            + dy0 + dyl) * num_dx;
#pragma unroll
      for (int kk = 0; kk < DXT; ++kk) {
        if (dx0 + kk < num_dx) o[dx0 + kk] = acc[q][kk];
      }
    }
  }
}

// The grid kernel over n source blocks: slices of at most MAX_DY dy rows
// (fewer when the dx groups are many), balanced; threads cover groups x
// rows, a whole number of warps.  Windows: block i's at windows + i *
// win_stride, rows row_stride bytes apart, win_h x win_w bytes.
template <int SIDE, int BASE, int WS = 0>
cudaError_t launch_grid(int n, const uint8_t* src, const uint8_t* windows, int win_stride,
                        int row_stride, int win_h, int win_w, int num_dy, int num_dx,
                        int32_t* grids, cudaStream_t stream) {
  static_assert(SIDE % BASE == 0 && BASE % 4 == 0 && SIDE <= 64, "bad block geometry");
  const int groups = (num_dx + DXT - 1) / DXT;
  if (num_dy < 1 || num_dx < 1 || groups > MAX_THREADS) return cudaErrorInvalidValue;
  const int dy_cap = MAX_THREADS / groups < MAX_DY ? MAX_THREADS / groups : MAX_DY;
  const int slices = (num_dy + dy_cap - 1) / dy_cap;
  const int dy = (num_dy + slices - 1) / slices;
  const int threads = (groups * dy + 31) / 32 * 32;
  const int ws = WS > 0 ? WS : staged_width(SIDE, num_dx);
  if (ws < DXT * groups + SIDE) return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(SIDE) * SIDE
                      + static_cast<size_t>(dy + SIDE - 1) * ws;
  if (smem > MAX_SMEM || slices > 65535) return cudaErrorInvalidValue;
  grid_kernel<SIDE, BASE, WS><<<dim3(n, slices), threads, smem, stream>>>(
      src, windows, win_stride, row_stride, win_h, win_w, num_dy, num_dx, dy, ws, grids);
  return cudaGetLastError();
}

}  // namespace hevc_grid
