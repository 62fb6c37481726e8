// Kernel B8: the exact SSD grid of square blocks against given windows.
//
// Replaces hevcasm_tpu/kernels/search_pallas.py ssd_grid (bodies _kernel,
// _kernel_chunked and _kernel_corr).  For block i of side B in
// {8, 16, 32, 64} and its window of at least (B + num_dy - 1) x
// (B + num_dx - 1) bytes:
//
//   out[i][dy][dx] = sum_{y,x < B} (win[i][dy + y][dx + x] - src[i][y][x])^2
//
// in exact int32 (a 64 x 64 sum is below 4096 * 255^2 < 2^31).  The PU
// decision runs it on the (B + 2R)^2 sub-block windows of
// encode/partition.base_grid_search wherever B14/B15 do not serve (R != 32),
// and the full search runs it on gathered CTU windows where K1 does not
// (search_impl="grid", R > 32).
//
// What bounds it on the H100: integer work: B^2 * num_dy *
// num_dx subtract-multiply-adds per block, 8.8 G for the 8160 16 x 16
// blocks of a 1920x1088 frame at R = 32, on the CUDA cores' int32 pipes.
// At B = 8 and 16 a block is little work, so the launch holds many small
// thread blocks (one per block and slice of dy rows).
//
// Design: the grid core of csrc/grid_core.cuh with one sub-block (SIDE =
// BASE = B): the block and the window rows of its dy slice staged in
// shared memory, each thread one dy and 8 dx in registers.  The TPU
// kernel's centred s^2 + box - 2 corr form, rolled source stacks and band
// reductions are MXU devices; the SSD is computed directly.

#include <cuda_runtime.h>
#include <stdint.h>

#include "grid_core.cuh"

// src (n, B, B) uint8 contiguous; windows: block i's at windows + i *
// win_stride, rows row_stride bytes apart, win_h x win_w bytes with win_h
// >= B + num_dy - 1 and win_w >= B + num_dx - 1; out (n, num_dy, num_dx)
// int32.  Launches on `stream` and returns cudaGetLastError()
// (cudaErrorInvalidValue for a geometry it does not take).
extern "C" int hevc_ssd_grid(const uint8_t* src, const uint8_t* windows, int win_stride,
                             int row_stride, int win_h, int win_w, int32_t* out, int n,
                             int b, int num_dy, int num_dx, int device, void* stream) {
  if (num_dy < 1 || num_dx < 1 || win_h < b + num_dy - 1 || win_w < b + num_dx - 1)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n == 0) return cudaGetLastError();
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define HEVC_LAUNCH(B)                                                                  \
  hevc_grid::launch_grid<B, B>(n, src, windows, win_stride, row_stride, win_h, win_w, \
                               num_dy, num_dx, out, s)
  switch (b) {
    case 8: return HEVC_LAUNCH(8);
    case 16: return HEVC_LAUNCH(16);
    case 32: return HEVC_LAUNCH(32);
    case 64: return HEVC_LAUNCH(64);
    default: return cudaErrorInvalidValue;
  }
#undef HEVC_LAUNCH
}
