// Kernel K2: quarter-pel refinement fused with the 8x8 residual pipeline.
//
// Replaces hevcasm_tpu/kernels/interp_pallas.py inter_ctu_fused_dma
// (_inter_kernel_dma -> _group_body -> residual_pallas.py
// residual_core_stacked).  Per 64x64 CTU, with nothing written to device
// memory between the steps:
//
//   1-4. rtc::refine (refine_tc_core.cuh): stage the window at offsets[i],
//      both 8-tap passes as mma.sync products with the filter's band as one
//      operand (m16n8k32 horizontally, m16n8k16 vertically), QPEL_SCORE of
//      the 16 candidates from the accumulator fragments, first minimum in
//      yf*4 + xf order;
//   5. the winner's accumulator from one more product pair a tile:
//      pred = clip((acc + 2048) >> 12, 0, 255) into shared memory;
//   6-8. residual_ctu8 (residual_core.cuh): 8x8 DCT, quantize, per-TU nnz
//      and Exp-Golomb bits, dequantize, inverse DCT, add and clip, the four
//      transform passes on mma.sync too; each warp codes the 32 x 16
//      pixels whose prediction it wrote in step 5, so no block barrier
//      separates the two steps.
//
// What bounds it on the H100: per CTU 9 KB in and 4.6 KB out (0.002 ms for
// 510 CTUs at 3.35 TB/s), and 144 m16n8k32 products (horizontal) and 1,088
// m16n8k16 (1,024 vertical, 64 for the winner, 256 the residual's): ~0.003
// ms at mma.sync's own rate, so neither bytes nor products; the CUDA-core
// work left (the score's 16 x 4096 absolute differences, the hi/lo stores,
// the quantizer) and the block's barriers are.  The design keeps every
// candidate in accumulator registers (no candidate plane in shared
// memory), and 51 KB of shared memory a block lets four CTUs share an SM,
// so 510 CTUs run in one wave.
//
// Two C entries launch the kernel: hevc_inter_fused takes the five quantizer
// parameters as ints (the kernel reads them from its parameter space), and
// hevc_inter_fused_q reads them from an int32[5] in device memory, for the rate
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
inter_fused_kernel(const uint8_t* __restrict__ src,
                   const uint8_t* __restrict__ plane,
                   const int32_t* __restrict__ offsets,
                   uint8_t* __restrict__ rec, int32_t* __restrict__ frac_out,
                   int32_t* __restrict__ cost_out, int32_t* __restrict__ nnz_out,
                   int32_t* __restrict__ bits_out, int plane_h, int plane_w, Q q) {
  // sm.win holds the window until the horizontal pass is done, then the
  // prediction; sm.hp holds the intermediate.
  extern __shared__ __align__(128) uint8_t smem[];
  const rtc::Smem sm = rtc::carve(smem);
  const int i = blockIdx.x;

  prefetch_qparams(q);
  rtc::stage_source(src + static_cast<size_t>(i) * B * B, sm.src);
  uint32_t w[4];
  rtc::band_words(w);
  int cost;
  const int best = rtc::refine(plane, plane_h, plane_w, offsets[2 * i], offsets[2 * i + 1],
                               sm, w, cost);
  if (threadIdx.x == 0) {
    frac_out[i] = best;
    cost_out[i] = cost;
  }

  // ---- 5. the winning prediction, into sm.win (row stride B) --------------
  // Each warp writes the pixels of its vertical-pass tiles, the pixels
  // residual_ctu8 gives it.
  // The hi product starts from 8: 8 * 256 = 2048, the rounding of >> 12.
#pragma unroll
  for (int j = 0; j < rtc::TILES; ++j) {
    int d[4];
    rtc::winner_acc(d, sm.hp, w, best, j, 8);
#pragma unroll
    for (int r = 0; r < 4; ++r)
      sm.win[rtc::tile_y(j, r) * B + rtc::tile_x(r)] = static_cast<uint8_t>(clip3(0, 255, d[r] >> 12));
  }
  __syncwarp();

  if (!qparams_ok(q)) return;
  residual_ctu8(sm.src, sm.win, rec + static_cast<size_t>(i) * B * B,
                nnz_out + static_cast<size_t>(i) * NTU * NTU,
                bits_out + static_cast<size_t>(i) * NTU * NTU, qparams(q));
}

template <class Q>
int launch(const uint8_t* src, const uint8_t* plane, const int32_t* offsets, uint8_t* rec,
           int32_t* frac, int32_t* cost, int32_t* nnz, int32_t* bits, int n, int plane_h,
           int plane_w, Q q, int device, void* stream) {
  if (plane_h < rtc::WIN || plane_w < rtc::WIN) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n == 0) return cudaGetLastError();
  err = cudaFuncSetAttribute(inter_fused_kernel<Q>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             rtc::SMEM);
  if (err != cudaSuccess) return err;
  inter_fused_kernel<Q><<<n, NT, rtc::SMEM, static_cast<cudaStream_t>(stream)>>>(
      src, plane, offsets, rec, frac, cost, nnz, bits, plane_h, plane_w, q);
  return cudaGetLastError();
}

}  // namespace

// src (n, 64, 64) uint8; plane (plane_h, plane_w) uint8 contiguous with
// plane_h, plane_w >= 71; offsets (n, 2) int32 window top-left [y, x];
// outputs rec (n, 64, 64) uint8, frac (n,), cost (n,), nnz (n, 8, 8),
// bits (n, 8, 8) int32.  The caller checks the quantizer ranges
// (1 <= qscale < 2^15, 16 <= qshift <= 27, 0 <= qoffset < 2^15,
// 1 <= dshift <= 31).  Launches on `stream`, returns cudaGetLastError().
extern "C" int hevc_inter_fused(const uint8_t* src, const uint8_t* plane,
                                const int32_t* offsets, uint8_t* rec,
                                int32_t* frac, int32_t* cost, int32_t* nnz,
                                int32_t* bits, int n, int plane_h, int plane_w,
                                int qscale, int qshift, int qoffset, int dscale,
                                int dshift, int device, void* stream) {
  if (qshift < 16 || qshift > 27 || dshift < 1 || dshift > 31) return cudaErrorInvalidValue;
  return launch(src, plane, offsets, rec, frac, cost, nnz, bits, n, plane_h, plane_w,
                QParams{qscale, qshift, qoffset, dscale, dshift}, device, stream);
}

// The same with the quantizer parameters in device memory: qvec int32[5]
// (qscale, qshift, qoffset, dscale, dshift), read by the kernel, so the
// caller needs no host copy of them.  A block whose parameters leave the
// ranges above ORs their bits (1 qscale, 2 qshift, 4 qoffset, 8 dshift)
// into *range_flag and writes no rec, nnz or bits.
extern "C" int hevc_inter_fused_q(const uint8_t* src, const uint8_t* plane,
                                  const int32_t* offsets, uint8_t* rec,
                                  int32_t* frac, int32_t* cost, int32_t* nnz,
                                  int32_t* bits, int n, int plane_h, int plane_w,
                                  const int32_t* qvec, int32_t* range_flag, int device,
                                  void* stream) {
  return launch(src, plane, offsets, rec, frac, cost, nnz, bits, n, plane_h, plane_w,
                DevQParams{qvec, range_flag}, device, stream);
}
