// Kernel K1: exact SSD grids of 64x64 CTUs, windows read from the plane.
//
// Replaces hevcasm_tpu/kernels/search_pallas.py ssd_grid_plane (body
// _kernel_slab).  For CTU i = (r, c) of a grid gc wide and every integer
// displacement (dy, dx) in [0, 2R]^2:
//
//   out[i][dy][dx] = sum_{y,x < 64} (plane[64r + dy + y][64c + dx + x]
//                                    - src[i][y][x])^2
//
// in exact int32 (the largest sum is 4096 * 255^2 < 2^31), for any radius
// 1 <= R <= 32 and any grid width.  The plane is the reference padded by R
// on the top and left.
//
// What bounds it on the H100: integer work.  Each CTU costs
// (2R+1)^2 * 4096 subtract-multiply-adds, 17.3 M at R = 32 and 8.8 G for a
// 1920x1088 frame, on the CUDA cores' int32 pipes.  Memory traffic is
// small: a block reads one 4 KB CTU and at most 79 x 128 window bytes.
//
// Design: one block per (CTU, slice of dy rows).  The block stages the CTU
// and the window rows its slice needs in shared memory.  Each thread owns
// one dy and DXT = 8 consecutive dx, and keeps its 8 sums in registers;
// per source row it reads the window as 4-byte words and slides over them
// in registers, so one shared load feeds 32 multiply-adds.  The source
// word is the same for every thread of the block and is broadcast.  The
// first-minimum argmin stays outside, in motion.full_search_slab.  The
// s8 x s8 -> s32 tensor-core form (sum s^2 + boxsum w^2 - 2 corr) is
// left for later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CTU = 64;
constexpr int DXT = 8;                                   // dx per thread
constexpr int MAX_R = 32;
constexpr int MAX_NUM = 2 * MAX_R + 1;                   // 65
constexpr int MAX_GROUPS = (MAX_NUM + DXT - 1) / DXT;    // 9
constexpr int MAX_DY = 16;                               // dy rows per block
constexpr int WROWS = MAX_DY + CTU - 1;                  // window rows staged
// Window row stride in bytes: every thread reads bytes [dx0, dx0 + 72) of a
// row, so rows hold 8 * MAX_GROUPS + 64 = 136 bytes; 140 keeps rows 4-byte
// aligned with an odd word count (35), which spreads rows over the banks.
constexpr int WS = 140;
static_assert(DXT * MAX_GROUPS + CTU <= WS, "window row too short");

__device__ __forceinline__ int byte_of(uint32_t w, int i) {
  return static_cast<int>((w >> (8 * i)) & 0xFFu);
}

__global__ void __launch_bounds__(256)
ssd_grid_plane_kernel(const uint8_t* __restrict__ src,
                      const uint8_t* __restrict__ plane,
                      int32_t* __restrict__ out, int gc, int plane_w,
                      int radius, int dy_per_block) {
  __shared__ __align__(16) uint8_t s_src[CTU * CTU];
  __shared__ __align__(16) uint8_t s_win[WROWS * WS];

  const int num = 2 * radius + 1;
  const int groups = (num + DXT - 1) / DXT;
  const int wide = CTU + 2 * radius;          // window height and width
  const int ctu = blockIdx.x;
  const int dy0 = blockIdx.y * dy_per_block;
  const int rows = min(dy_per_block, num - dy0);
  const int wrows = rows + CTU - 1;
  const size_t row0 = static_cast<size_t>(ctu / gc) * CTU + dy0;
  const size_t col0 = static_cast<size_t>(ctu % gc) * CTU;

  const uint8_t* s = src + static_cast<size_t>(ctu) * CTU * CTU;
  for (int i = threadIdx.x; i < CTU * CTU; i += blockDim.x) s_src[i] = s[i];
  // Bytes past the window's width (and rows past its height) are zero;
  // they only reach candidates dx >= num, which are never written.
  for (int i = threadIdx.x; i < wrows * WS; i += blockDim.x) {
    const int y = i / WS, x = i - y * WS;
    uint8_t v = 0;
    if (x < wide && dy0 + y < wide) v = plane[(row0 + y) * plane_w + col0 + x];
    s_win[i] = v;
  }
  __syncthreads();

  const int g = threadIdx.x % groups;
  const int dyl = threadIdx.x / groups;
  if (dyl >= rows) return;
  const int dx0 = g * DXT;

  int acc[DXT];
#pragma unroll
  for (int k = 0; k < DXT; ++k) acc[k] = 0;

  for (int y = 0; y < CTU; ++y) {
    const uint32_t* wrow =
        reinterpret_cast<const uint32_t*>(s_win + (dyl + y) * WS + dx0);
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
        for (int k = 0; k < DXT; ++k) {
          const int d = wv[i + k] - sv;
          acc[k] += d * d;
        }
      }
      w0 = w1;
      w1 = w2;
    }
  }

  int32_t* o = out + (static_cast<size_t>(ctu) * num + dy0 + dyl) * num;
#pragma unroll
  for (int k = 0; k < DXT; ++k) {
    if (dx0 + k < num) o[dx0 + k] = acc[k];
  }
}

}  // namespace

// src (n, 64, 64) uint8; plane (plane_h, plane_w) uint8, contiguous, with
// plane_h >= 64 * (n / gc) + 2R and plane_w >= 64 * gc + 2R (the caller
// checks); out (n, 2R+1, 2R+1) int32.  Launches on `stream` and returns
// cudaGetLastError().
extern "C" int hevc_ssd_grid_plane(const uint8_t* src, const uint8_t* plane,
                                   int32_t* out, int n, int gc, int plane_h,
                                   int plane_w, int radius, int device,
                                   void* stream) {
  (void)plane_h;
  if (radius < 1 || radius > MAX_R || gc < 1) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n == 0) return cudaGetLastError();
  const int num = 2 * radius + 1;
  const int groups = (num + DXT - 1) / DXT;
  const int slices = (num + MAX_DY - 1) / MAX_DY;
  const int dy_per_block = (num + slices - 1) / slices;
  const int threads = (groups * dy_per_block + 31) / 32 * 32;
  const dim3 grid(n, slices);
  ssd_grid_plane_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      src, plane, out, gc, plane_w, radius, dy_per_block);
  return cudaGetLastError();
}
