// The exhaustive SSD search of a 64x64 CTU with its first minimum, shared by
// B17 (csrc/search_mv.cu) and B19 (csrc/mega.cu).
//
// For the CTU's (64 + 2R)^2 window and every displacement (dy, dx) in
// [0, 2R]^2, SSD(dy, dx) = sum_{y,x < 64} (win[dy + y][dx + x] - src[y][x])^2
// in exact int32 (below 4096 * 255^2 < 2^31).  The search keeps only the
// first minimum in row-major [dy, dx] order, as the packed key
//
//   key = (SSD << 32) | (dy * (2R + 1) + dx)
//
// whose plain unsigned minimum is that first minimum: the smaller SSD wins,
// then the smaller index.  Keys combine with min() in any order, so warps,
// blocks and slices of dy rows reduce them with shuffles, shared memory and
// atomicMin.
//
// The inner loop is the CUDA-core loop K1 ran before its tensor-core form
// (csrc/grid_core.cuh; K1 now runs csrc/ssd_tc_core.cuh): the window rows
// staged in shared memory with a row stride of WS bytes, one thread owning
// one dy and DXT = 8 consecutive dx, sliding 4-byte window words over them
// in registers, so one shared load feeds 32 subtract-multiply-adds.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace hevc_search {

constexpr int CTU = 64;
constexpr int DXT = 8;                                   // dx per thread
constexpr int MAX_R = 32;
constexpr int MAX_NUM = 2 * MAX_R + 1;                   // 65
constexpr int MAX_GROUPS = (MAX_NUM + DXT - 1) / DXT;    // 9
// Staged window row stride in bytes: a thread reads bytes [dx0, dx0 + 72) of
// a row, so rows hold 8 * MAX_GROUPS + 64 = 136 bytes; 140 keeps rows 4-byte
// aligned with an odd word count (35), which spreads rows over the banks.
constexpr int WS = 140;
constexpr unsigned long long NO_KEY = ~0ull;
static_assert(DXT * MAX_GROUPS + CTU <= WS, "window row too short");

__device__ __forceinline__ int byte_of(uint32_t w, int i) {
  return static_cast<int>((w >> (8 * i)) & 0xFFu);
}

// Stage window rows [row0, row0 + rows) of a window `wide` bytes square
// whose top-left byte is w (rows row_stride bytes apart) into s_win, row
// stride WS.  Bytes past the window's width, and rows past its height, are
// zero: they reach only candidates dx >= 2R + 1, which never count.
__device__ __forceinline__ void stage_window(const uint8_t* __restrict__ w,
                                             size_t row_stride, int row0, int rows,
                                             int wide, uint8_t* s_win) {
  for (int i = threadIdx.x; i < rows * WS; i += blockDim.x) {
    const int y = i / WS, x = i - y * WS;
    uint8_t v = 0;
    if (x < wide && row0 + y < wide) v = w[static_cast<size_t>(row0 + y) * row_stride + x];
    s_win[i] = v;
  }
}

// The first-minimum key of candidates (dy, dx0 .. dx0 + DXT - 1), dx < num,
// with wrow the staged row of displacement dy (s_win + dyl * WS) and s_src
// the CTU (64 x 64, row stride 64).
__device__ __forceinline__ unsigned long long ssd_key8(const uint8_t* wrow0,
                                                       const uint8_t* s_src, int dy,
                                                       int dx0, int num) {
  int acc[DXT];
#pragma unroll
  for (int j = 0; j < DXT; ++j) acc[j] = 0;
  for (int y = 0; y < CTU; ++y) {
    const uint32_t* wrow = reinterpret_cast<const uint32_t*>(wrow0 + y * WS + dx0);
    const uint32_t* srow = reinterpret_cast<const uint32_t*>(s_src + y * CTU);
    uint32_t w0 = wrow[0], w1 = wrow[1];
#pragma unroll
    for (int xb = 0; xb < CTU / 4; ++xb) {
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
        for (int j = 0; j < DXT; ++j) {
          const int d = wv[i + j] - sv;
          acc[j] += d * d;
        }
      }
      w0 = w1;
      w1 = w2;
    }
  }
  unsigned long long key = NO_KEY;
#pragma unroll
  for (int j = 0; j < DXT; ++j) {
    if (dx0 + j < num) {
      const unsigned long long k =
          (static_cast<unsigned long long>(static_cast<uint32_t>(acc[j])) << 32)
          | static_cast<uint32_t>(dy * num + dx0 + j);
      key = k < key ? k : key;
    }
  }
  return key;
}

// The minimum key over the block, returned to every thread.  s_red holds
// blockDim.x / 32 keys; blockDim.x is a multiple of 32.
__device__ __forceinline__ unsigned long long block_min_key(unsigned long long key,
                                                            unsigned long long* s_red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long o = __shfl_xor_sync(0xffffffffu, key, off);
    key = o < key ? o : key;
  }
  const int warps = blockDim.x / 32;
  if ((threadIdx.x & 31) == 0) s_red[threadIdx.x >> 5] = key;
  __syncthreads();
  key = s_red[0];
  for (int wi = 1; wi < warps; ++wi) key = s_red[wi] < key ? s_red[wi] : key;
  __syncthreads();  // s_red may be reused once every thread has read it
  return key;
}

}  // namespace hevc_search
