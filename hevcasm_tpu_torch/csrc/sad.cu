// Kernel B10: the SAD of blocks against one reference each, or against k.
//
// Replaces hevcasm_tpu/kernels/sad_pallas.py sad (body _sad_kernel) and
// sad_multiref (body _sad_multiref_kernel).  For block i of h x w pixels
// (any h, w with h * w * 255 < 2^31) and reference j of its k:
//
//   out[i][j] = sum_{y < h, x < w} |src[i][y][x] - ref[i][j][y][x]|
//
// in exact int32.  No encode path calls it: it is the KERNEL tier of the
// registry's sad and sad_multiref, which the self-test sweeps over the 23
// HEVC partitions from 4x8 to 64x64.
//
// What bounds it on the H100: the bytes.  Every pixel pair is read once
// and takes one __usad (absolute difference and add in one instruction);
// 510 64x64 blocks at k = 4 move 10.4 MB, 3.1 us at 3.35 TB/s, against
// 10.4 M terms.  At the self-test's single partitions the launch dominates.
//
// Design: one block of NTH threads per (block, reference) pair walks the
// h x w pixels in row-major order, NTH apart, so a warp reads neighbouring
// bytes of a row (widths 4, 12, 24 and 48 need no alignment: every load is
// one byte at any stride); a warp-shuffle and shared-memory reduction
// gives the sum.  Rows may be any number of bytes apart and blocks and
// references any distance, so strided views of larger planes are read in
// place.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTH = 128;

__global__ void __launch_bounds__(NTH)
sad_kernel(const uint8_t* __restrict__ src, long long src_stride, long long src_row,
           const uint8_t* __restrict__ refs, long long ref_stride, long long ref_k_stride,
           long long ref_row, int32_t* __restrict__ out, int k, int h, int w) {
  __shared__ unsigned red[NTH / 32];
  const int pair = blockIdx.x;
  const int i = pair / k, j = pair - i * k;
  const uint8_t* s = src + i * src_stride;
  const uint8_t* r = refs + i * ref_stride + j * ref_k_stride;
  unsigned acc = 0;
  for (int p = threadIdx.x; p < h * w; p += NTH) {
    const int y = p / w, x = p - y * w;
    acc = __usad(s[y * src_row + x], r[y * ref_row + x], acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned total = 0;
#pragma unroll
    for (int wi = 0; wi < NTH / 32; ++wi) total += red[wi];
    out[pair] = static_cast<int32_t>(total);
  }
}

cudaError_t launch(const uint8_t* src, long long src_stride, long long src_row,
                   const uint8_t* refs, long long ref_stride, long long ref_k_stride,
                   long long ref_row, int32_t* out, int n, int k, int h, int w, int device,
                   void* stream) {
  if (n < 0 || k < 1 || h < 1 || w < 1 || static_cast<long long>(h) * w * 255 >= (1LL << 31)
      || static_cast<long long>(n) * k >= (1LL << 31))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n == 0) return cudaGetLastError();
  sad_kernel<<<n * k, NTH, 0, static_cast<cudaStream_t>(stream)>>>(
      src, src_stride, src_row, refs, ref_stride, ref_k_stride, ref_row, out, k, h, w);
  return cudaGetLastError();
}

}  // namespace

// src and ref (n, h, w) uint8: block i at src + i * src_stride, rows
// src_row bytes apart (the same for ref); out (n,) int32.  Launches on
// `stream` and returns cudaGetLastError() (cudaErrorInvalidValue for a
// shape it does not take).
extern "C" int hevc_sad(const uint8_t* src, long long src_stride, long long src_row,
                        const uint8_t* ref, long long ref_stride, long long ref_row,
                        int32_t* out, int n, int h, int w, int device, void* stream) {
  return launch(src, src_stride, src_row, ref, ref_stride, 0, ref_row, out, n, 1, h, w,
                device, stream);
}

// src (n, h, w) uint8 as in hevc_sad; refs (n, k, h, w) uint8: reference j
// of block i at refs + i * ref_stride + j * ref_k_stride, rows ref_row bytes
// apart; out (n, k) int32.
extern "C" int hevc_sad_multiref(const uint8_t* src, long long src_stride,
                                 long long src_row, const uint8_t* refs,
                                 long long ref_stride, long long ref_k_stride,
                                 long long ref_row, int32_t* out, int n, int k, int h,
                                 int w, int device, void* stream) {
  return launch(src, src_stride, src_row, refs, ref_stride, ref_k_stride, ref_row, out, n,
                k, h, w, device, stream);
}
