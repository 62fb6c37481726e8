// Kernel B11: quarter-pel refinement of square blocks on gathered windows.
//
// Replaces hevcasm_tpu/kernels/interp_pallas.py refine_quarter_pel_fused
// (_kernel -> _refine_core).  For block i of side BB in {8, 16, 32, 64} and
// its window at the integer MV (only the top-left (BB+7) x (BB+7) is read):
//
//   1-3. refine_select_at (refine_core.cuh): stage the window, 4 int16
//      horizontal passes, QPEL_SCORE of the 16 candidates, first minimum in
//      yf*4 + xf order;
//   4. the winner is recomputed and written: pred = clip((acc + 2048) >> 12,
//      0, 255), with frac = yf*4 + xf and its score.
//
// It is K2's refinement with the winning prediction written out in place of
// the residual stage.
//
// What bounds it on the H100: per 64x64 block about 0.6 M multiply-adds
// (the 16 vertical candidates) against 9 KB of input and 4 KB of output;
// neither compute nor bandwidth is near its limit (510 CTUs: 0.3 G
// multiply-adds, 6.7 MB), latency is: one block refines one block of pixels
// in four barrier-separated phases.  The design is one block per pixel
// block, with 256 threads (64 at BB = 8, whose 64 pixels would leave the
// rest idle) and every thread on one column of BB * BB / threads rows, so
// small blocks keep many thread blocks resident on an SM (a 16x16 block
// needs 4.3 KB of shared memory and 32 registers a thread).

#include "refine_core.cuh"

namespace {

template <int BB>
__host__ __device__ constexpr int threads_for() {
  return BB == 8 ? 64 : NT;
}

template <int BB>
__global__ void __launch_bounds__(threads_for<BB>())
refine_fused_kernel(const uint8_t* __restrict__ src,
                    const uint8_t* __restrict__ windows, long long tile_stride,
                    int row_stride, uint8_t* __restrict__ pred,
                    int32_t* __restrict__ frac_out, int32_t* __restrict__ cost_out) {
  constexpr int NTH = threads_for<BB>();
  using S = RefineSmemT<BB, NTH>;
  __shared__ S sm;
  __shared__ __align__(16) uint8_t s_src[BB * BB];

  const int i = blockIdx.x;
  const int t = threadIdx.x;
  const uint8_t* s = src + static_cast<size_t>(i) * BB * BB;
  for (int k = t; k < BB * BB; k += NTH) s_src[k] = s[k];
  const int best = refine_select_at<BB, NTH>(windows + i * tile_stride, row_stride,
                                             s_src, sm);
  if (t == 0) {
    frac_out[i] = best;
    cost_out[i] = sm.cost[best];
  }
  const int x = t % BB, yg = t / BB;
  uint8_t* p = pred + static_cast<size_t>(i) * BB * BB;
#pragma unroll 4
  for (int yy = 0; yy < S::ROWS; ++yy)
    p[(S::ROWS * yg + yy) * BB + x] = static_cast<uint8_t>(
        clip3(0, 255, (winner_acc(sm, best, x, yg, yy) + 2048) >> 12));
}

template <int BB>
cudaError_t launch(const uint8_t* src, const uint8_t* windows, long long tile_stride,
                   int row_stride, uint8_t* pred, int32_t* frac, int32_t* cost, int n,
                   cudaStream_t stream) {
  refine_fused_kernel<BB><<<n, threads_for<BB>(), 0, stream>>>(
      src, windows, tile_stride, row_stride, pred, frac, cost);
  return cudaGetLastError();
}

}  // namespace

// src (n, b, b) uint8 contiguous; windows: block i's window at windows +
// i * tile_stride, rows row_stride bytes apart, at least (b+7) x (b+7);
// pred (n, b, b) uint8, frac (n,) and cost (n,) int32.  b in {8, 16, 32,
// 64}.  Launches on `stream` and returns cudaGetLastError().
extern "C" int hevc_refine_fused(const uint8_t* src, const uint8_t* windows,
                                 long long tile_stride, int row_stride, uint8_t* pred,
                                 int32_t* frac, int32_t* cost, int n, int b, int device,
                                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n == 0) return cudaGetLastError();
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (b) {
    case 8: return launch<8>(src, windows, tile_stride, row_stride, pred, frac, cost, n, s);
    case 16: return launch<16>(src, windows, tile_stride, row_stride, pred, frac, cost, n, s);
    case 32: return launch<32>(src, windows, tile_stride, row_stride, pred, frac, cost, n, s);
    case 64: return launch<64>(src, windows, tile_stride, row_stride, pred, frac, cost, n, s);
    default: return cudaErrorInvalidValue;
  }
}
