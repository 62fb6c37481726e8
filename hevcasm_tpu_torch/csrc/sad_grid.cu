// Kernel B9: the exact SAD grid of square blocks against given windows.
//
// Replaces hevcasm_tpu/kernels/sad_pallas.py sad_grid (body
// _sad_grid_kernel).  For block i of side B in {8, 16, 32, 64} and its
// window of at least (B + num_dy - 1) x (B + num_dx - 1) bytes:
//
//   out[i][dy][dx] = sum_{y,x < B} |win[i][dy + y][dx + x] - src[i][y][x]|
//
// in exact int32.  Every search under me_metric="sad" runs it: the full
// search on gathered CTU windows, both levels of the pyramid search, the PU
// decision's sub-block grids, and the multi-reference and B-frame searches.
//
// What bounds it on the H100: integer work on the CUDA cores.  |a - b| is
// not a product, so the int8 tensor cores cannot run it: 8.8 G terms for
// the 510 CTUs of a 1920x1088 frame at R = 32, which the packed
// vabsdiff4.add could take four to an instruction and this design takes
// in three (a subtract, an absolute value and an add).  Memory traffic is
// small (a block and its window in, the grid out).
//
// Design: B8's (csrc/ssd_grid.cu), the grid core of csrc/grid_core.cuh with
// one sub-block and Metric::SAD: the block and the window rows of its dy
// slice staged in shared memory, each thread one dy and 8 dx in registers,
// one 4-byte shared load feeding 32 terms.  The TPU kernel's aligned 8-row
// band loads are a Mosaic constraint and are not carried over.

#include <cuda_runtime.h>
#include <stdint.h>

#include "grid_core.cuh"

// src (n, B, B) uint8 contiguous; windows: block i's at windows + i *
// win_stride, rows row_stride bytes apart, win_h x win_w bytes with win_h
// >= B + num_dy - 1 and win_w >= B + num_dx - 1; out (n, num_dy, num_dx)
// int32.  Launches on `stream` and returns cudaGetLastError()
// (cudaErrorInvalidValue for a geometry it does not take).
extern "C" int hevc_sad_grid(const uint8_t* src, const uint8_t* windows, int win_stride,
                             int row_stride, int win_h, int win_w, int32_t* out, int n,
                             int b, int num_dy, int num_dx, int device, void* stream) {
  if (num_dy < 1 || num_dx < 1 || win_h < b + num_dy - 1 || win_w < b + num_dx - 1)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n == 0) return cudaGetLastError();
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  using hevc_grid::Metric;
#define HEVC_LAUNCH(B)                                                             \
  hevc_grid::launch_grid<B, B, 0, Metric::SAD>(n, src, windows, win_stride,        \
                                               row_stride, win_h, win_w, num_dy,   \
                                               num_dx, out, s)
  switch (b) {
    case 8: return HEVC_LAUNCH(8);
    case 16: return HEVC_LAUNCH(16);
    case 32: return HEVC_LAUNCH(32);
    case 64: return HEVC_LAUNCH(64);
    default: return cudaErrorInvalidValue;
  }
#undef HEVC_LAUNCH
}
