// Kernel B3: bi-prediction refine + combine fused with the 8x8 residual.
//
// Replaces hevcasm_tpu/kernels/interp_pallas.py bi_ctu_fused_dma
// (_bi_kernel_dma -> _refine_core per reference -> residual_pallas.py
// residual_core_stacked).  Per 64x64 CTU, with nothing written to device
// memory between the steps:
//
//   1-3. refine_select (refine_core.cuh) on reference 0's window at
//      offsets0[i]: fetch, 4 int16 horizontal passes, QPEL_SCORE of the 16
//      candidates, first minimum in yf*4 + xf order;
//   4a. each thread keeps its 16 pixels of reference 0's int16 bi
//      intermediate p0 = wrap16(acc >> 6) of the winner, in registers;
//   1-3. the same on reference 1's window at offsets1[i], through the same
//      shared buffers;
//   4b. p1 = wrap16(acc >> 6) of reference 1's winner, and the prediction
//      pred = clip((p0 + p1 + 64) >> 7, 0, 255) into shared memory;
//   5-7. residual_core<8> (residual_core.cuh): 8x8 DCT, quantize, per-TU
//      nnz and Exp-Golomb bits, dequantize, inverse DCT, add and clip.
//
// The shift is arithmetic on the unbiased accumulator (the TPU kernel
// carries a +2048 rounding bias in its raw quadrants and subtracts it
// back); the int16 wrap follows the shift.  The two fractions are chosen
// independently.  offsets1 usually points into the lower half of two
// padded planes stacked by rows; each start is clamped to the whole plane
// exactly as the plain version's window gather does.
//
// What bounds it on the H100: per CTU about 1.4 M multiply-adds (twice
// K2's refinement, one residual) against 14 KB of input, so, as for K2,
// neither compute nor bandwidth is near its limit; latency is: one block
// runs both refinements and the residual in eleven barrier-separated
// phases.  The design reuses K2's shared buffers for the second reference
// instead of holding two sets of horizontal passes (72 KB would need
// dynamic shared memory and halve the blocks per SM): only the winner's
// 16 intermediates per thread survive the first refinement, in registers,
// so shared memory stays at K2's ~47 KB, under the 48 KB static limit.

#include "refine_core.cuh"

namespace {

constexpr int NTU = B / 8;    // 8x8 TUs per CTU side

__global__ void __launch_bounds__(NT)
bi_fused_kernel(const uint8_t* __restrict__ src,
                const uint8_t* __restrict__ plane,
                const int32_t* __restrict__ offsets0,
                const int32_t* __restrict__ offsets1,
                uint8_t* __restrict__ rec, int32_t* __restrict__ frac0_out,
                int32_t* __restrict__ frac1_out, int32_t* __restrict__ nnz_out,
                int32_t* __restrict__ bits_out, int plane_h, int plane_w,
                int qscale, int qshift, int qoffset, int dscale, int dshift) {
  __shared__ RefineSmem sm;
  __shared__ __align__(16) uint8_t s_src[B * B];
  __shared__ int s_nnz[NTU * NTU];
  __shared__ int s_bits[NTU * NTU];

  const int i = blockIdx.x;
  const int t = threadIdx.x;
  const int x = t % B, yg = t / B;

  const uint8_t* s = src + static_cast<size_t>(i) * B * B;
  for (int k = t; k < B * B; k += NT) s_src[k] = s[k];

  // ---- reference 0: refine, keep the winner's intermediates ---------------
  const int best0 = refine_select(plane, plane_h, plane_w, offsets0[2 * i],
                                  offsets0[2 * i + 1], s_src, sm);
  int p0[16];
#pragma unroll
  for (int yy = 0; yy < 16; ++yy)
    p0[yy] = wrap16(winner_acc(sm, best0, x, yg, yy) >> 6);

  // ---- reference 1: refine through the same buffers, combine --------------
  // refine_select's first barrier (after its window fetch, which touches
  // only sm.win) orders every read of reference 0's passes above before
  // the passes are overwritten.
  const int best1 = refine_select(plane, plane_h, plane_w, offsets1[2 * i],
                                  offsets1[2 * i + 1], s_src, sm);
  if (t == 0) {
    frac0_out[i] = best0;
    frac1_out[i] = best1;
  }
  uint8_t* s_pred = sm.win;  // (B, B), row stride B
#pragma unroll
  for (int yy = 0; yy < 16; ++yy) {
    const int p1 = wrap16(winner_acc(sm, best1, x, yg, yy) >> 6);
    s_pred[(16 * yg + yy) * B + x] =
        static_cast<uint8_t>(clip3(0, 255, (p0[yy] + p1 + 64) >> 7));
  }
  __syncthreads();

  residual_core<8>(s_src, s_pred, reinterpret_cast<int*>(sm.hp), s_nnz, s_bits,
                    rec + static_cast<size_t>(i) * B * B,
                    nnz_out + static_cast<size_t>(i) * NTU * NTU,
                    bits_out + static_cast<size_t>(i) * NTU * NTU, qscale,
                    qshift, qoffset, dscale, dshift);
}

}  // namespace

// src (n, 64, 64) uint8; plane (plane_h, plane_w) uint8 contiguous with
// plane_h, plane_w >= 71; offsets0/offsets1 (n, 2) int32 window top-left
// [y, x] per reference; outputs rec (n, 64, 64) uint8, frac0 (n,), frac1
// (n,), nnz (n, 8, 8), bits (n, 8, 8) int32.  The caller checks the
// quantizer ranges (1 <= qscale < 2^15, 16 <= qshift <= 27,
// 0 <= qoffset < 2^15, 1 <= dshift <= 31).  Launches on `stream`, returns
// cudaGetLastError().
extern "C" int hevc_bi_fused(const uint8_t* src, const uint8_t* plane,
                             const int32_t* offsets0, const int32_t* offsets1,
                             uint8_t* rec, int32_t* frac0, int32_t* frac1,
                             int32_t* nnz, int32_t* bits, int n, int plane_h,
                             int plane_w, int qscale, int qshift, int qoffset,
                             int dscale, int dshift, int device, void* stream) {
  if (plane_h < WIN || plane_w < WIN || qshift < 16 || qshift > 27 ||
      dshift < 1 || dshift > 31)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n == 0) return cudaGetLastError();
  bi_fused_kernel<<<n, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      src, plane, offsets0, offsets1, rec, frac0, frac1, nnz, bits, plane_h,
      plane_w, qscale, qshift, qoffset, dscale, dshift);
  return cudaGetLastError();
}
