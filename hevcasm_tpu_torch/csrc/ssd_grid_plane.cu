// Kernels K1 and B7: exact SSD grids of 64x64 CTUs, windows read from one
// reference plane (K1) or from each of k planes (B7).
//
// K1 replaces hevcasm_tpu/kernels/search_pallas.py ssd_grid_plane (body
// _kernel_slab), B7 ssd_grid_plane_multi (body _kernel_slab_multi).  For
// CTU i = (r, c) of a grid gc wide, plane p and every integer displacement
// (dy, dx) in [0, 2R]^2:
//
//   out[i][p][dy][dx] = sum_{y,x < 64} (plane_p[64r + dy + y][64c + dx + x]
//                                       - src[i][y][x])^2
//
// in exact int32 (the largest sum is 4096 * 255^2 < 2^31), for any radius
// 1 <= R <= 32 and any grid width.  Each plane is a reference padded by R
// on the top and left; K1 is the case k = 1.
//
// What bounds it on the H100: integer work.  Each CTU costs
// (2R+1)^2 * 4096 subtract-multiply-adds a plane, 17.3 M at R = 32 and
// 8.8 G for a 1920x1088 frame, on the CUDA cores' int32 pipes.  Memory
// traffic is small: a block reads one 4 KB CTU and at most 79 x 128 window
// bytes a plane, and B7 writes 510 * k * 65^2 * 4 bytes (34.5 MB at k = 4).
//
// Design: one block per (CTU, slice of dy rows).  The block stages the CTU
// in shared memory once, then for each plane in turn the window rows its
// slice needs (the point of the TPU's multi-plane body: the source side is
// prepared once for all k planes).  Each thread owns one dy and DXT = 8
// consecutive dx, and keeps its 8 sums in registers; per source row it
// reads the window as 4-byte words and slides over them in registers, so
// one shared load feeds 32 multiply-adds.  The source word is the same for
// every thread of the block and is broadcast.  The first-minimum argmin
// stays outside, in motion.full_search_slab / full_search_multi.  The
// s8 x s8 -> s32 tensor-core form (sum s^2 + boxsum w^2 - 2 corr) is left
// for later work.

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
                      const uint8_t* __restrict__ planes,
                      int32_t* __restrict__ out, int gc, long long plane_stride,
                      int row_stride, int k, int radius, int dy_per_block) {
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

  const int g = threadIdx.x % groups;
  const int dyl = threadIdx.x / groups;
  const bool active = dyl < rows;
  const int dx0 = g * DXT;

  for (int p = 0; p < k; ++p) {
    // Every thread is done with the previous plane's window rows.
    if (p > 0) __syncthreads();
    const uint8_t* plane = planes + p * plane_stride;
    // Bytes past the window's width (and rows past its height) are zero;
    // they only reach candidates dx >= num, which are never written.
    for (int i = threadIdx.x; i < wrows * WS; i += blockDim.x) {
      const int y = i / WS, x = i - y * WS;
      uint8_t v = 0;
      if (x < wide && dy0 + y < wide) v = plane[(row0 + y) * row_stride + col0 + x];
      s_win[i] = v;
    }
    __syncthreads();
    if (!active) continue;

    int acc[DXT];
#pragma unroll
    for (int j = 0; j < DXT; ++j) acc[j] = 0;

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
          for (int j = 0; j < DXT; ++j) {
            const int d = wv[i + j] - sv;
            acc[j] += d * d;
          }
        }
        w0 = w1;
        w1 = w2;
      }
    }

    int32_t* o = out + ((static_cast<size_t>(ctu) * k + p) * num + dy0 + dyl) * num;
#pragma unroll
    for (int j = 0; j < DXT; ++j) {
      if (dx0 + j < num) o[dx0 + j] = acc[j];
    }
  }
}

cudaError_t launch(const uint8_t* src, const uint8_t* planes, int32_t* out, int n,
                   int k, int gc, long long plane_stride, int row_stride, int radius,
                   int device, cudaStream_t stream) {
  if (radius < 1 || radius > MAX_R || gc < 1 || k < 1) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n == 0) return cudaGetLastError();
  const int num = 2 * radius + 1;
  const int groups = (num + DXT - 1) / DXT;
  const int slices = (num + MAX_DY - 1) / MAX_DY;
  const int dy_per_block = (num + slices - 1) / slices;
  const int threads = (groups * dy_per_block + 31) / 32 * 32;
  const dim3 grid(n, slices);
  ssd_grid_plane_kernel<<<grid, threads, 0, stream>>>(
      src, planes, out, gc, plane_stride, row_stride, k, radius, dy_per_block);
  return cudaGetLastError();
}

}  // namespace

// K1.  src (n, 64, 64) uint8; plane (plane_h, plane_w) uint8, contiguous,
// with plane_h >= 64 * (n / gc) + 2R and plane_w >= 64 * gc + 2R (the
// caller checks); out (n, 2R+1, 2R+1) int32.  Launches on `stream` and
// returns cudaGetLastError().
extern "C" int hevc_ssd_grid_plane(const uint8_t* src, const uint8_t* plane,
                                   int32_t* out, int n, int gc, int plane_h,
                                   int plane_w, int radius, int device,
                                   void* stream) {
  (void)plane_h;
  return launch(src, plane, out, n, 1, gc, 0, plane_w, radius, device,
                static_cast<cudaStream_t>(stream));
}

// B7.  src (n, 64, 64) uint8 contiguous; k planes, plane p at planes +
// p * plane_stride, rows row_stride bytes apart, each at least
// 64 * (n / gc) + 2R rows of 64 * gc + 2R bytes (the caller checks); out
// (n, k, 2R+1, 2R+1) int32.  Launches on `stream` and returns
// cudaGetLastError().
extern "C" int hevc_ssd_grid_plane_multi(const uint8_t* src, const uint8_t* planes,
                                         int32_t* out, int n, int k, int gc,
                                         long long plane_stride, int row_stride,
                                         int radius, int device, void* stream) {
  return launch(src, planes, out, n, k, gc, plane_stride, row_stride, radius, device,
                static_cast<cudaStream_t>(stream));
}
