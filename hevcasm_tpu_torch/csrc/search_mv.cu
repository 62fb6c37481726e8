// Kernel B17: the exhaustive SSD search of 64x64 CTUs with the first minimum
// taken in the kernel, so the (2R+1)^2 score grids never reach device memory.
//
// Replaces hevcasm_tpu/kernels/search_pallas.py search_mv (body
// _kernel_chunked_mv, windows gathered by the caller) and search_mv_dma
// (body _search_kernel_dma, windows read from the padded reference plane):
// one C entry serves both, since each reads CTU i's (64 + 2R)^2 window at a
// per-CTU (row, col) offset into a plane.  search_mv_dma passes the loop's
// padded reference and the CTU positions + PAD_L; search_mv passes the
// contiguous stack of n gathered windows viewed as a plane of n * Wh rows,
// window i at (i * Wh, 0).  Output per CTU: mv = [dy - R, dx - R] and the
// best SSD of the first minimum in row-major [dy, dx] order, the result of
// motion.full_search.
//
// What bounds it on the H100: integer work: (2R+1)^2 * 4096
// subtract-multiply-adds per CTU, 8.8 G for a 1920x1088 frame at R = 32, on
// the CUDA cores' int32 pipes.  The grid write K1 makes (510 * 65^2 * 4 =
// 8.6 MB a frame) and the first-minimum pass over it are gone.
//
// Design: the CUDA-core SSD loop of csrc/search_core.cuh (K1's design
// before K1 moved to the tensor cores): one block per (CTU, slice of at
// most 16 dy rows), 13 rows and 117 busy threads at R = 32.  Each thread turns its 8 sums into
// one packed key (SSD << 32 | dy * num + dx); warp shuffles and one step
// through shared memory reduce the block to one key, and one atomicMin on a
// per-CTU uint64 combines the slices, as B15 does (csrc/base_grids.cu).  A
// second small kernel decodes the keys.  The TPU kernels' chunked-K
// matmuls, band matrices, slab DMAs and lane rolls are Mosaic devices and
// are not carried over.

#include <cuda_runtime.h>
#include <stdint.h>

#include "search_core.cuh"

namespace {

using namespace hevc_search;

constexpr int MAX_DY = 16;                   // dy rows per block
constexpr int THREADS = 128;                 // >= 9 groups * 13 rows at R = 32

__global__ void __launch_bounds__(THREADS)
search_mv_kernel(const uint8_t* __restrict__ src, const uint8_t* __restrict__ plane,
                 const int32_t* __restrict__ offsets, int plane_h, int plane_w,
                 int radius, int dy_per_block, unsigned long long* __restrict__ keys) {
  __shared__ __align__(16) uint8_t s_src[CTU * CTU];
  __shared__ __align__(16) uint8_t s_win[(MAX_DY + CTU - 1) * WS];
  __shared__ unsigned long long s_red[THREADS / 32];

  const int num = 2 * radius + 1;
  const int groups = (num + DXT - 1) / DXT;
  const int wide = CTU + 2 * radius;
  const int ctu = blockIdx.x;
  const int dy0 = blockIdx.y * dy_per_block;
  const int rows = min(dy_per_block, num - dy0);

  // The window start, clamped so the window fits (as the plain version's
  // gather clamps).
  const int oy = min(max(offsets[2 * ctu], 0), plane_h - wide);
  const int ox = min(max(offsets[2 * ctu + 1], 0), plane_w - wide);
  const uint8_t* s = src + static_cast<size_t>(ctu) * CTU * CTU;
  for (int i = threadIdx.x; i < CTU * CTU; i += blockDim.x) s_src[i] = s[i];
  stage_window(plane + static_cast<size_t>(oy) * plane_w + ox, plane_w, dy0,
               rows + CTU - 1, wide, s_win);
  __syncthreads();

  const int g = threadIdx.x % groups;
  const int dyl = threadIdx.x / groups;
  unsigned long long key = NO_KEY;
  if (dyl < rows) key = ssd_key8(s_win + dyl * WS, s_src, dy0 + dyl, g * DXT, num);
  key = block_min_key(key, s_red);
  if (threadIdx.x == 0) atomicMin(&keys[ctu], key);
}

__global__ void decode_kernel(const unsigned long long* __restrict__ keys,
                              int32_t* __restrict__ mv, int32_t* __restrict__ best,
                              int n, int radius) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int num = 2 * radius + 1;
  const unsigned long long key = keys[i];
  const int idx = static_cast<int>(key & 0xFFFFFFFFull);
  mv[2 * i] = idx / num - radius;
  mv[2 * i + 1] = idx % num - radius;
  best[i] = static_cast<int>(key >> 32);
}

}  // namespace

// src (n, 64, 64) uint8 contiguous; plane (plane_h, plane_w) uint8
// contiguous, at least (64 + 2R) square; offsets (n, 2) int32 window
// top-left [y, x] (a start past the plane's end is clamped so the window
// fits); keys (n,) uint64 scratch; outputs mv (n, 2) and best (n,) int32.
// Three operations on `stream`: the keys are set to ~0, the search keeps
// each CTU's minimum key, the decode writes mv and best.  Returns
// cudaGetLastError() (cudaErrorInvalidValue for 1 > R or R > 32 or a plane
// smaller than one window).
extern "C" int hevc_search_mv(const uint8_t* src, const uint8_t* plane, const int32_t* offsets,
                              unsigned long long* keys, int32_t* mv, int32_t* best, int n,
                              int plane_h, int plane_w, int radius, int device, void* stream) {
  if (radius < 1 || radius > MAX_R) return cudaErrorInvalidValue;
  const int wide = CTU + 2 * radius;
  if (plane_h < wide || plane_w < wide) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n == 0) return cudaGetLastError();
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(keys, 0xFF, static_cast<size_t>(n) * sizeof(unsigned long long), s);
  if (err != cudaSuccess) return err;
  const int num = 2 * radius + 1;
  const int slices = (num + MAX_DY - 1) / MAX_DY;
  const int dy_per_block = (num + slices - 1) / slices;
  if ((num + DXT - 1) / DXT * dy_per_block > THREADS) return cudaErrorInvalidValue;
  search_mv_kernel<<<dim3(n, slices), THREADS, 0, s>>>(src, plane, offsets, plane_h, plane_w,
                                                       radius, dy_per_block, keys);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_kernel<<<(n + 255) / 256, 256, 0, s>>>(keys, mv, best, n, radius);
  return cudaGetLastError();
}
