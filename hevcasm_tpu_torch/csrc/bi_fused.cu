// Kernel B3: bi-prediction refine + combine fused with the 8x8 residual.
//
// Replaces hevcasm_tpu/kernels/interp_pallas.py bi_ctu_fused_dma
// (_bi_kernel_dma -> _refine_core per reference -> residual_pallas.py
// residual_core_stacked).  Per 64x64 CTU, with nothing written to device
// memory between the steps:
//
//   1-4. reference 0's window at offsets0[i] through K2's tensor-core
//      refinement (refine_tc_core.cuh): both 8-tap passes as mma.sync
//      products, QPEL_SCORE from the accumulator fragments, first
//      minimum in yf*4 + xf order; reference 1's window (offsets1[i]) is
//      staged between reference 0's horizontal and vertical passes: the
//      window buffer is free once the horizontal pass has read it, so the
//      staging needs no barrier of its own;
//   5a. each thread keeps its 16 pixels of reference 0's int16 bi
//      intermediate p0 = wrap16(acc >> 6) of the winner, recomputed by one
//      product pair a tile, in registers in the fragment's lane layout;
//   1-4. the same for reference 1, through the same buffers;
//   5b. p1 = wrap16(acc >> 6) of reference 1's winner arrives in the same
//      layout, so pred = clip((p0 + p1 + 64) >> 7, 0, 255) needs no
//      exchange; it goes to shared memory;
//   6-8. residual_ctu8 (residual_core.cuh): 8x8 DCT, quantize, per-TU nnz
//      and Exp-Golomb bits, dequantize, inverse DCT, add and clip, the
//      transform passes on mma.sync; each warp codes the pixels whose
//      prediction it wrote, after a __syncwarp only.
//
// The shift is arithmetic on the unbiased accumulator (the TPU kernel
// carries a +2048 rounding bias in its raw quadrants and subtracts it
// back); the int16 wrap follows the shift.  The two fractions are chosen
// independently.  offsets1 usually points into the lower half of two
// padded planes stacked by rows; each start is clamped to the whole plane
// exactly as the plain version's window gather does.
//
// What bounds it on the H100: per CTU 14 KB in and 4.6 KB out (0.003 ms for
// 510 CTUs at 3.35 TB/s) and twice K2's products (~0.006 ms at mma.sync's
// own rate), so, as for K2, the CUDA-core work around the
// products (two scores, the hi/lo stores, one residual) and the barriers
// bound it.  One set of buffers serves both references (K2's 51 KB, four
// blocks an SM); only the 8 packed registers of p0 survive the first.
//
// Two C entries launch the kernel: hevc_bi_fused takes the five quantizer
// parameters as ints (the kernel reads them from its parameter space), and
// hevc_bi_fused_q reads them from an int32[5] in device memory, for the rate
// controller, which keeps qp on the card (encode/rate.py).  The kernel is a
// template on that source (QParams or DevQParams, refine_tc_core.cuh): the
// device-q instance copies the vector to shared memory as it starts, so the
// load hides behind the refinement, and checks the ranges before the
// residual stage, setting their bits in a range flag.  Both instances take
// 64 registers and spill nothing.

#include "refine_tc_core.cuh"

namespace {

constexpr int NTU = B / 8;    // 8x8 TUs per CTU side

// Q is where the quantizer parameters come from: QParams (host ints, by
// value) or DevQParams (a device int32[5] and a range flag).
template <class Q>
__global__ void __launch_bounds__(NT, 4)
bi_fused_kernel(const uint8_t* __restrict__ src,
                const uint8_t* __restrict__ plane,
                const int32_t* __restrict__ offsets0,
                const int32_t* __restrict__ offsets1,
                uint8_t* __restrict__ rec, int32_t* __restrict__ frac0_out,
                int32_t* __restrict__ frac1_out, int32_t* __restrict__ nnz_out,
                int32_t* __restrict__ bits_out, int plane_h, int plane_w, Q q) {
  extern __shared__ __align__(128) uint8_t smem[];
  const rtc::Smem sm = rtc::carve(smem);
  const int i = blockIdx.x;

  prefetch_qparams(q);
  rtc::stage_source(src + static_cast<size_t>(i) * B * B, sm.src);
  uint32_t w[4];
  rtc::band_words(w);

  // ---- reference 0: refine, keep the winner's intermediates ---------------
  rtc::stage_window(plane, plane_h, plane_w, offsets0[2 * i], offsets0[2 * i + 1], sm.win);
  __syncthreads();
  rtc::horizontal_pass(sm.win, sm.hp);
  __syncthreads();
  rtc::stage_window(plane, plane_h, plane_w, offsets1[2 * i], offsets1[2 * i + 1], sm.win);
  rtc::vertical_scores(sm.hp, sm.src, w, sm.red);
  int best_cost;
  const int best0 = rtc::first_min(sm.red, best_cost);
  if (threadIdx.x == 0) frac0_out[i] = best0;
  // p0[2j + h]: rows y, y + 1 of column x + 8h in tile j, as two int16.
  uint32_t p0[2 * rtc::TILES];
#pragma unroll
  for (int j = 0; j < rtc::TILES; ++j) {
    int d[4];
    rtc::winner_acc(d, sm.hp, w, best0, j, 0);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      p0[2 * j + h] = __byte_perm(static_cast<uint32_t>(wrap16(d[2 * h] >> 6)),
                                  static_cast<uint32_t>(wrap16(d[2 * h + 1] >> 6)), 0x5410);
  }
  // Every warp has read reference 0's intermediate and staged its share of
  // reference 1's window.
  __syncthreads();

  // ---- reference 1: refine through the same buffers, combine --------------
  rtc::horizontal_pass(sm.win, sm.hp);
  __syncthreads();
  rtc::vertical_scores(sm.hp, sm.src, w, sm.red);
  const int best1 = rtc::first_min(sm.red, best_cost);
  if (threadIdx.x == 0) frac1_out[i] = best1;
  // The prediction goes to sm.win (row stride B): the horizontal pass has
  // read the window.  Each warp writes the pixels residual_ctu8 gives it.
#pragma unroll
  for (int j = 0; j < rtc::TILES; ++j) {
    int d[4];
    rtc::winner_acc(d, sm.hp, w, best1, j, 0);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const uint32_t q = p0[2 * j + (r >> 1)];
      const int p = (r & 1) ? static_cast<int>(q) >> 16 : static_cast<int>(q << 16) >> 16;
      sm.win[rtc::tile_y(j, r) * B + rtc::tile_x(r)] =
          static_cast<uint8_t>(clip3(0, 255, (p + wrap16(d[r] >> 6) + 64) >> 7));
    }
  }
  __syncwarp();

  if (!qparams_ok(q)) return;
  residual_ctu8(sm.src, sm.win, rec + static_cast<size_t>(i) * B * B,
                nnz_out + static_cast<size_t>(i) * NTU * NTU,
                bits_out + static_cast<size_t>(i) * NTU * NTU, qparams(q));
}

template <class Q>
int launch(const uint8_t* src, const uint8_t* plane, const int32_t* offsets0,
           const int32_t* offsets1, uint8_t* rec, int32_t* frac0, int32_t* frac1,
           int32_t* nnz, int32_t* bits, int n, int plane_h, int plane_w, Q q, int device,
           void* stream) {
  if (plane_h < rtc::WIN || plane_w < rtc::WIN) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n == 0) return cudaGetLastError();
  err = cudaFuncSetAttribute(bi_fused_kernel<Q>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             rtc::SMEM);
  if (err != cudaSuccess) return err;
  bi_fused_kernel<Q><<<n, NT, rtc::SMEM, static_cast<cudaStream_t>(stream)>>>(
      src, plane, offsets0, offsets1, rec, frac0, frac1, nnz, bits, plane_h, plane_w, q);
  return cudaGetLastError();
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
  if (qshift < 16 || qshift > 27 || dshift < 1 || dshift > 31) return cudaErrorInvalidValue;
  return launch(src, plane, offsets0, offsets1, rec, frac0, frac1, nnz, bits, n, plane_h,
                plane_w, QParams{qscale, qshift, qoffset, dscale, dshift}, device, stream);
}

// The same with the quantizer parameters in device memory: qvec int32[5]
// (qscale, qshift, qoffset, dscale, dshift), read by the kernel, so the
// caller needs no host copy of them.  A block whose parameters leave the
// ranges above ORs their bits (1 qscale, 2 qshift, 4 qoffset, 8 dshift)
// into *range_flag and writes no rec, nnz or bits.
extern "C" int hevc_bi_fused_q(const uint8_t* src, const uint8_t* plane,
                               const int32_t* offsets0, const int32_t* offsets1,
                               uint8_t* rec, int32_t* frac0, int32_t* frac1,
                               int32_t* nnz, int32_t* bits, int n, int plane_h,
                               int plane_w, const int32_t* qvec, int32_t* range_flag,
                               int device, void* stream) {
  return launch(src, plane, offsets0, offsets1, rec, frac0, frac1, nnz, bits, n, plane_h,
                plane_w, DevQParams{qvec, range_flag}, device, stream);
}
