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
// What bounds it on the H100: the bytes.  Every pixel pair is read once;
// 510 64x64 blocks at k = 4 move 10.4 MB, 3.1 us at 3.35 TB/s, against
// 10.4 M terms, a quarter of that many packed instructions.  At the
// self-test's single partitions, and at the frame shapes too (2.7 us of
// kernel), the caller's host work and the launch dominate: so the C entry
// takes its arguments as one block (below), and does nothing per call
// beyond the launch (no cudaSetDevice when the device is already current).
//
// Design: one warp per (block, reference) pair, four pairs a 128-thread
// block (510 pairs make 128 blocks: more SMs than at eight a block).  Where
// both operands' base, row and block strides are multiples of 16 bytes and
// w is too (the 64x64 frame blocks, 64x48 views), each lane takes 16-byte
// chunks and sums them four bytes at a time with __vsadu4 (packed absolute
// difference and add); otherwise (widths 4, 12, 24 and 48 at odd strides,
// the self-test's views at offset (1, 1)) it takes single bytes with
// __usad.  Lanes step through the chunks in row-major order 32 apart, the
// row and column carried without a division; the warp's sum is one
// __reduce_add_sync.  Rows may be any number of bytes apart and blocks and
// references any distance, so strided views of larger planes are read in
// place.

#include <cuda_runtime.h>
#include <stdint.h>

// One call's arguments, each a 64-bit integer, in this order, so that the
// caller's ctypes call converts one pointer and not fourteen values (each
// conversion costs ~0.3 us of host time, and the call is host-bound).
struct SadArgs {
  long long src, src_stride, src_row;   // block i at src + i * src_stride, rows src_row apart
  long long refs, ref_stride, ref_k_stride, ref_row;   // reference j of block i at
                                                       // refs + i * ref_stride + j * ref_k_stride
  long long out, n, k, h, w;            // out (n, k) int32
  long long device, stream;
};

namespace {

constexpr int PAIRS = 4;                 // warps, i.e. (block, reference) pairs, a block

template <int V>   // bytes a lane reads at once: 16 (aligned) or 1
__global__ void __launch_bounds__(32 * PAIRS)
sad_kernel(const uint8_t* __restrict__ src, long long src_stride, long long src_row,
           const uint8_t* __restrict__ refs, long long ref_stride, long long ref_k_stride,
           long long ref_row, int32_t* __restrict__ out, int pairs, int k, int h, int w) {
  const int pair = blockIdx.x * PAIRS + (threadIdx.x >> 5);
  if (pair >= pairs) return;
  const int lane = threadIdx.x & 31;
  const int i = pair / k, j = pair - i * k;
  const uint8_t* s = src + i * src_stride;
  const uint8_t* r = refs + i * ref_stride + j * ref_k_stride;
  const int units = w / V, total = h * units;
  // Lane p's chunk is (p / units, p % units); 32 chunks on is 32 / units
  // rows and 32 % units chunks further.
  const int step_y = 32 / units, step_x = 32 - step_y * units;
  int y = lane / units, x = lane - y * units;
  unsigned acc = 0;
#pragma unroll 4
  for (int p = lane; p < total; p += 32) {
    if (V == 16) {
      const uint4 a = *reinterpret_cast<const uint4*>(s + y * src_row + 16 * x);
      const uint4 b = *reinterpret_cast<const uint4*>(r + y * ref_row + 16 * x);
      acc += __vsadu4(a.x, b.x) + __vsadu4(a.y, b.y) + __vsadu4(a.z, b.z) +
             __vsadu4(a.w, b.w);
    } else {
      acc = __usad(s[y * src_row + x], r[y * ref_row + x], acc);
    }
    x += step_x;
    y += step_y;
    if (x >= units) {
      x -= units;
      ++y;
    }
  }
  acc = __reduce_add_sync(0xffffffffu, acc);
  if (lane == 0) out[pair] = static_cast<int32_t>(acc);
}

cudaError_t launch(const SadArgs& a) {
  if (a.n < 0 || a.k < 1 || a.h < 1 || a.w < 1 || a.h * a.w * 255 >= (1LL << 31)
      || a.n * a.k >= (1LL << 31) - 32 * PAIRS || a.device < 0 || a.device >= (1LL << 31))
    return cudaErrorInvalidValue;
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != a.device) err = cudaSetDevice(static_cast<int>(a.device));
  if (err != cudaSuccess) return err;
  if (a.n == 0) return cudaGetLastError();
  const int pairs = static_cast<int>(a.n * a.k);
  const unsigned blocks = (pairs + PAIRS - 1) / PAIRS;
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(a.stream);
  const auto* src = reinterpret_cast<const uint8_t*>(a.src);
  const auto* refs = reinterpret_cast<const uint8_t*>(a.refs);
  auto* out = reinterpret_cast<int32_t*>(a.out);
  const int k = static_cast<int>(a.k), h = static_cast<int>(a.h), w = static_cast<int>(a.w);
  if (((a.src | a.refs | a.src_stride | a.src_row | a.ref_stride | a.ref_k_stride | a.ref_row |
        a.w) & 15) == 0)
    sad_kernel<16><<<blocks, 32 * PAIRS, 0, s>>>(src, a.src_stride, a.src_row, refs, a.ref_stride,
                                                 a.ref_k_stride, a.ref_row, out, pairs, k, h, w);
  else
    sad_kernel<1><<<blocks, 32 * PAIRS, 0, s>>>(src, a.src_stride, a.src_row, refs, a.ref_stride,
                                                a.ref_k_stride, a.ref_row, out, pairs, k, h, w);
  return cudaGetLastError();
}

}  // namespace

// sad: src and ref (n, h, w) uint8 (k = 1, ref_k_stride unused); out (n,)
// int32.  Launches on the stream and returns cudaGetLastError()
// (cudaErrorInvalidValue for a shape it does not take).
extern "C" int hevc_sad(const SadArgs* args) {
  if (args->k != 1) return cudaErrorInvalidValue;
  return launch(*args);
}

// sad_multiref: src (n, h, w) and refs (n, k, h, w) uint8; out (n, k) int32.
extern "C" int hevc_sad_multiref(const SadArgs* args) { return launch(*args); }
