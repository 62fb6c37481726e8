// Kernel K2: quarter-pel refinement fused with the 8x8 residual pipeline.
//
// Replaces hevcasm_tpu/kernels/interp_pallas.py inter_ctu_fused_dma
// (_inter_kernel_dma -> _group_body -> residual_pallas.py
// residual_core_stacked).  Per 64x64 CTU, with nothing written to device
// memory between the steps:
//
//   1-3. refine_select (refine_core.cuh): fetch the 71x71 window at
//      offsets[i], 4 int16 horizontal passes, QPEL_SCORE of the 16
//      candidates, first minimum in yf*4 + xf order;
//   4. the winner is recomputed: pred = clip((acc + 2048) >> 12, 0, 255);
//   5-7. residual_core<8> (residual_core.cuh): 8x8 DCT, quantize, per-TU
//      nnz and Exp-Golomb bits, dequantize, inverse DCT, add and clip.
//
// What bounds it on the H100: per CTU about 0.7 M multiply-adds (the 16
// vertical candidates dominate) against 9 KB of input, so neither compute
// nor bandwidth is near its limit; latency is: one block does a CTU's work
// in seven phases separated by barriers.  The 16 full candidate planes
// (256 KB of int32) do not fit in shared memory, so the design keeps only
// the four int16 horizontal passes (36 KB) there, scores every candidate
// from them, and recomputes the winner.  About 47 KB of shared memory per
// block lets four CTUs share an SM, so a 510-CTU frame runs in one wave.

#include "refine_core.cuh"

namespace {

constexpr int NTU = B / 8;    // 8x8 TUs per CTU side

__global__ void __launch_bounds__(NT)
inter_fused_kernel(const uint8_t* __restrict__ src,
                   const uint8_t* __restrict__ plane,
                   const int32_t* __restrict__ offsets,
                   uint8_t* __restrict__ rec, int32_t* __restrict__ frac_out,
                   int32_t* __restrict__ cost_out, int32_t* __restrict__ nnz_out,
                   int32_t* __restrict__ bits_out, int plane_h, int plane_w,
                   int qscale, int qshift, int qoffset, int dscale,
                   int dshift) {
  // sm.win holds the window until the H passes are done, then the
  // prediction; sm.hp holds the H passes until the winner is recomputed,
  // then the residual stage's two int32 64x64 planes.
  __shared__ RefineSmem sm;
  __shared__ __align__(16) uint8_t s_src[B * B];
  __shared__ int s_nnz[NTU * NTU];
  __shared__ int s_bits[NTU * NTU];

  const int i = blockIdx.x;
  const int t = threadIdx.x;

  const uint8_t* s = src + static_cast<size_t>(i) * B * B;
  for (int k = t; k < B * B; k += NT) s_src[k] = s[k];
  const int best = refine_select(plane, plane_h, plane_w, offsets[2 * i],
                                 offsets[2 * i + 1], s_src, sm);
  if (t == 0) {
    frac_out[i] = best;
    cost_out[i] = sm.cost[best];
  }

  // ---- 4. the winning prediction, into sm.win -----------------------------
  uint8_t* s_pred = sm.win;  // (B, B), row stride B
  const int x = t % B, yg = t / B;
#pragma unroll 4
  for (int yy = 0; yy < 16; ++yy)
    s_pred[(16 * yg + yy) * B + x] = static_cast<uint8_t>(
        clip3(0, 255, (winner_acc(sm, best, x, yg, yy) + 2048) >> 12));
  __syncthreads();

  residual_core<8>(s_src, s_pred, reinterpret_cast<int*>(sm.hp), s_nnz, s_bits,
                    rec + static_cast<size_t>(i) * B * B,
                    nnz_out + static_cast<size_t>(i) * NTU * NTU,
                    bits_out + static_cast<size_t>(i) * NTU * NTU, qscale,
                    qshift, qoffset, dscale, dshift);
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
  if (plane_h < WIN || plane_w < WIN || qshift < 16 || qshift > 27 ||
      dshift < 1 || dshift > 31)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n == 0) return cudaGetLastError();
  inter_fused_kernel<<<n, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      src, plane, offsets, rec, frac, cost, nnz, bits, plane_h, plane_w,
      qscale, qshift, qoffset, dscale, dshift);
  return cudaGetLastError();
}
