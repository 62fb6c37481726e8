// Kernel B11: quarter-pel refinement of square blocks on gathered windows.
//
// Replaces hevcasm_tpu/kernels/interp_pallas.py refine_quarter_pel_fused
// (_kernel -> _refine_core).  For block i of side S in {8, 16, 32, 64} and
// its window at the integer MV (only the top-left (S+7) x (S+7) is read):
//
//   1-3. both 8-tap passes on the u8/s8 tensor cores and QPEL_SCORE of the
//      16 candidates from the accumulator fragments: at S <= 32 a warp a
//      block (two at S = 8), eight a thread block (refine_tile_kernel,
//      refine_tile_tc.cuh); at S = 64 K2's 64x64 block core on the gathered
//      window (refine_ctu_kernel, refine_tc_core.cuh);
//   4. the first minimum in yf*4 + xf order; the winner is recomputed with
//      one more product pair a fragment and written: pred = clip((acc +
//      2048) >> 12, 0, 255), with frac = yf*4 + xf and its score.
//
// It is K2's refinement with the winning prediction written out in place of
// the residual stage.
//
// What bounds it on the H100: per 64x64 block 9 KB in and 4 KB out (0.0020
// ms for 510 blocks at 3.35 TB/s), and 144 m16n8k32 and 1,088 m16n8k16
// products (~0.003 ms at mma.sync's own rates); what is left is K2's: the
// score's absolute differences, the hi/lo stores and the block's barriers.
// A 16x16 block takes 12 m16n8k32 and 68 m16n8k16 products; its warp
// fetches its own window and meets no other warp at a barrier.

#include "refine_tile_tc.cuh"

namespace {

template <int S>
__global__ void __launch_bounds__(NT, rtc::Tile<S>::MIN_BLOCKS)
refine_tile_kernel(const uint8_t* __restrict__ src, const uint8_t* __restrict__ windows,
                   long long tile_stride, int row_stride, uint8_t* __restrict__ pred,
                   int32_t* __restrict__ frac_out, int32_t* __restrict__ cost_out, int n) {
  using T = rtc::Tile<S>;
  extern __shared__ __align__(128) uint8_t smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tile0 = (blockIdx.x * rtc::NWARPS + warp) * T::PER_WARP;
  if (tile0 >= n) return;
  const int count = min(T::PER_WARP, n - tile0);
  uint8_t* win = smem + warp * T::WARP_BYTES;
  uint8_t* hp = win + T::WIN_BYTES;
  uint32_t w[4];
  int res[T::PER_WARP][4];
  rtc::tile_sums<S>(src, tile0, count, win, hp,
                    [&](int i, uint8_t* to) {
                      rtc::stage_tile<S>(windows + i * tile_stride, row_stride, to);
                    },
                    w, res);
  int best[T::PER_WARP];
#pragma unroll
  for (int p = 0; p < T::PER_WARP; ++p) {
    int cost;
    best[p] = rtc::tile_first_min(res[p], cost);
    if (lane == 0 && p < count) {
      frac_out[tile0 + p] = best[p];
      cost_out[tile0 + p] = cost;
    }
  }
  // The window is free since the horizontal pass: the predictions go there,
  // then out as words (S * S is a multiple of 64).
  rtc::tile_winner<S>(hp, w, best, win);
  __syncwarp();
  uint32_t* out = reinterpret_cast<uint32_t*>(pred + static_cast<size_t>(tile0) * S * S);
  for (int k = lane; k < count * S * S / 4; k += 32)
    out[k] = reinterpret_cast<const uint32_t*>(win)[k];
}

__global__ void __launch_bounds__(NT, 4)
refine_ctu_kernel(const uint8_t* __restrict__ src, const uint8_t* __restrict__ windows,
                  long long tile_stride, int row_stride, uint8_t* __restrict__ pred,
                  int32_t* __restrict__ frac_out, int32_t* __restrict__ cost_out) {
  extern __shared__ __align__(128) uint8_t smem[];
  const rtc::Smem sm = rtc::carve(smem);
  const int i = blockIdx.x;
  rtc::stage_source(src + static_cast<size_t>(i) * B * B, sm.src);
  uint32_t w[4];
  rtc::band_words(w);
  rtc::scores_gathered(windows + i * tile_stride, row_stride, sm, w);
  int cost;
  const int best = rtc::first_min(sm.red, cost);
  if (threadIdx.x == 0) {
    frac_out[i] = best;
    cost_out[i] = cost;
  }
  // The winning prediction into sm.win (row stride B), then out; the hi
  // product starts from 8: 8 * 256 = 2048, the rounding of >> 12.
#pragma unroll
  for (int j = 0; j < rtc::TILES; ++j) {
    int d[4];
    rtc::winner_acc(d, sm.hp, w, best, j, 8);
#pragma unroll
    for (int r = 0; r < 4; ++r)
      sm.win[rtc::tile_y(j, r) * B + rtc::tile_x(r)] = static_cast<uint8_t>(clip3(0, 255, d[r] >> 12));
  }
  __syncthreads();
  uint4* out = reinterpret_cast<uint4*>(pred + static_cast<size_t>(i) * B * B);
  out[threadIdx.x] = reinterpret_cast<const uint4*>(sm.win)[threadIdx.x];
  static_assert(NT * 16 == B * B, "a 16-byte store a thread");
}

template <int S>
cudaError_t launch(const uint8_t* src, const uint8_t* windows, long long tile_stride,
                   int row_stride, uint8_t* pred, int32_t* frac, int32_t* cost, int n,
                   cudaStream_t stream) {
  using T = rtc::Tile<S>;
  const cudaError_t err = rtc::allow_shared(refine_tile_kernel<S>, T::SMEM);
  if (err != cudaSuccess) return err;
  refine_tile_kernel<S><<<(n + T::PER_BLOCK - 1) / T::PER_BLOCK, NT, T::SMEM, stream>>>(
      src, windows, tile_stride, row_stride, pred, frac, cost, n);
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
    case 64:
      err = rtc::allow_shared(refine_ctu_kernel, rtc::SMEM);
      if (err != cudaSuccess) return err;
      refine_ctu_kernel<<<n, NT, rtc::SMEM, s>>>(src, windows, tile_stride, row_stride, pred,
                                                  frac, cost);
      return cudaGetLastError();
    default: return cudaErrorInvalidValue;
  }
}
