// Kernels B12 and B13: the quarter-pel cost maps of small blocks.
//
// Replaces hevcasm_tpu/kernels/interp_pallas.py refine_qpel_costmap (bodies
// _costmap_kernel_stacked for b <= 32, _costmap_kernel above) and
// refine_qpel_costmap_dma (_costmap_kernel_dma).  For tile i of side S in
// {8, 16, 32, 64} and its (S+7) x (S+7) window anchored at the integer MV:
//
//   cost[i][yf][xf] = sum_{y,x < S} |acc_{yf,xf}(y, x) - (src[i][y][x] << 12)| >> 4
//
// where acc is the pre-clip vertical 8-tap accumulation over the four
// horizontal passes, each wrapped to int16 (ops/pred_inter.qpel_costmap).
// Every term is below 2^18, so a 64x64 sum stays below 2^30.  There is no
// selection and no prediction: the PU decision sums the maps of a PU's
// tiles and picks one fraction per PU (encode/partition.py).
//
// Two C entries: hevc_costmap reads windows the caller gathered (B12);
// hevc_costmap_dma reads each window from the plane at its offset, clamped
// so it fits as motion.extract_windows clamps, and also writes the window
// out for the chosen-fraction interpolation (B13).  Both run the FIR passes
// on the u8/s8 tensor cores: at S <= 32 refine_tile_tc.cuh, a warp a tile
// (two at S = 8) and eight a block (costmap_windows_kernel,
// costmap_plane_kernel); B12 at S = 64 K2's 64x64 block core on the gathered
// window (costmap_ctu_kernel, refine_tc_core.cuh).
//
// What bounds it on the H100: the 8160 16x16 tiles of a 1080p PU decision
// are ~0.36 G multiply-adds and ~6 MB of windows and sources (0.0028 ms at
// 3.35 TB/s); their 12 m16n8k32 and 64 m16n8k16 products a tile take
// ~0.003 ms at mma.sync's own rates.  What is left is the score's absolute
// differences on the CUDA cores and the window fetch (23 scattered rows of
// 23 bytes a tile: latency, hidden by the 32 warps an SM, each fetching its
// own tile).  A warp's tiles need no barrier, so no warp waits for
// another's fetch.

#include "refine_tile_tc.cuh"

namespace {

// The sums of the warp's tiles (rtc::tile_sums), each tile's 16 written
// by lanes 0, 8, 16 and 24 (its yf) as one 16-byte store of the 4 xf.
template <int S, typename Stage>
__device__ __forceinline__ void costmap_warp(const uint8_t* __restrict__ src,
                                             int32_t* __restrict__ cost, int tile0, int count,
                                             uint8_t* win, uint8_t* hp, Stage stage) {
  const int lane = threadIdx.x & 31;
  uint32_t w[4];
  int res[rtc::Tile<S>::PER_WARP][4];
  rtc::tile_sums<S>(src, tile0, count, win, hp, stage, w, res);
  if (!(lane & 7)) {
#pragma unroll
    for (int p = 0; p < rtc::Tile<S>::PER_WARP; ++p)
      if (p < count)
        *reinterpret_cast<int4*>(cost + static_cast<size_t>(tile0 + p) * 16 + ((lane >> 3) & 3) * 4) =
            make_int4(res[p][0], res[p][1], res[p][2], res[p][3]);
  }
}

// B12 at S <= 32: tile i's window at windows + i * tile_stride, rows
// row_stride apart.
template <int S>
__global__ void __launch_bounds__(NT, rtc::Tile<S>::MIN_BLOCKS)
costmap_windows_kernel(const uint8_t* __restrict__ src, const uint8_t* __restrict__ windows,
                       long long tile_stride, int row_stride, int32_t* __restrict__ cost, int n) {
  using T = rtc::Tile<S>;
  extern __shared__ __align__(128) uint8_t smem[];
  const int warp = threadIdx.x >> 5;
  const int tile0 = (blockIdx.x * rtc::NWARPS + warp) * T::PER_WARP;
  if (tile0 >= n) return;
  uint8_t* win = smem + warp * T::WARP_BYTES;
  costmap_warp<S>(src, cost, tile0, min(T::PER_WARP, n - tile0), win, win + T::WIN_BYTES,
                  [&](int i, uint8_t* to) {
                    rtc::stage_tile<S>(windows + i * tile_stride, row_stride, to);
                  });
}

// B13: tile i's window in the plane at offsets[i] = [y, x], clamped so it
// fits; the staged windows, which the warp keeps, are then written to
// win_out (n, S+7, S+7).
template <int S>
__global__ void __launch_bounds__(NT, rtc::Tile<S>::MIN_BLOCKS)
costmap_plane_kernel(const uint8_t* __restrict__ src, const uint8_t* __restrict__ plane,
                     const int32_t* __restrict__ offsets, int plane_h, int plane_w,
                     int32_t* __restrict__ cost, uint8_t* __restrict__ win_out, int n) {
  using T = rtc::Tile<S>;
  extern __shared__ __align__(128) uint8_t smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tile0 = (blockIdx.x * rtc::NWARPS + warp) * T::PER_WARP;
  if (tile0 >= n) return;
  const int count = min(T::PER_WARP, n - tile0);
  uint8_t* win = smem + warp * T::WARP_BYTES;
  costmap_warp<S>(
      src, cost, tile0, count, win, win + T::WIN_BYTES,
      [&](int i, uint8_t* to) {
        const int y0 = clip3(0, plane_h - T::WIN, __ldg(offsets + 2 * i));
        const int x0 = clip3(0, plane_w - T::WIN, __ldg(offsets + 2 * i + 1));
        rtc::stage_tile<S>(plane + static_cast<size_t>(y0) * plane_w + x0, plane_w, to);
      });
  for (int p = 0; p < count; ++p) {
    uint8_t* out = win_out + static_cast<size_t>(tile0 + p) * T::WIN * T::WIN;
    for (int k = lane; k < T::WIN * T::WIN; k += 32) {
      const int r = k / T::WIN;
      out[k] = win[r * T::WS + 16 * p + k - r * T::WIN];
    }
  }
}

// B12 at S = 64: K2's block core on the gathered window, then the block's
// 16 sums.
__global__ void __launch_bounds__(NT, 4)
costmap_ctu_kernel(const uint8_t* __restrict__ src, const uint8_t* __restrict__ windows,
                   long long tile_stride, int row_stride, int32_t* __restrict__ cost) {
  extern __shared__ __align__(128) uint8_t smem[];
  const rtc::Smem sm = rtc::carve(smem);
  const int i = blockIdx.x;
  rtc::stage_source(src + static_cast<size_t>(i) * B * B, sm.src);
  uint32_t w[4];
  rtc::band_words(w);
  rtc::scores_gathered(windows + i * tile_stride, row_stride, sm, w);
  __syncthreads();
  if (threadIdx.x < 16) {
    int total = 0;
#pragma unroll
    for (int k = 0; k < rtc::NWARPS; ++k) total += sm.red[k * 16 + threadIdx.x];
    cost[static_cast<size_t>(i) * 16 + threadIdx.x] = total;
  }
}

template <int S>
cudaError_t launch_windows(const uint8_t* src, const uint8_t* windows, long long tile_stride,
                           int row_stride, int32_t* cost, int n, cudaStream_t stream) {
  using T = rtc::Tile<S>;
  const cudaError_t err = rtc::allow_shared(costmap_windows_kernel<S>, T::SMEM);
  if (err != cudaSuccess) return err;
  costmap_windows_kernel<S><<<(n + T::PER_BLOCK - 1) / T::PER_BLOCK, NT, T::SMEM, stream>>>(
      src, windows, tile_stride, row_stride, cost, n);
  return cudaGetLastError();
}

template <int S>
cudaError_t launch_plane(const uint8_t* src, const uint8_t* plane, const int32_t* offsets,
                         int plane_h, int plane_w, int32_t* cost, uint8_t* win_out, int n,
                         cudaStream_t stream) {
  using T = rtc::Tile<S>;
  const cudaError_t err = rtc::allow_shared(costmap_plane_kernel<S>, T::SMEM);
  if (err != cudaSuccess) return err;
  costmap_plane_kernel<S><<<(n + T::PER_BLOCK - 1) / T::PER_BLOCK, NT, T::SMEM, stream>>>(
      src, plane, offsets, plane_h, plane_w, cost, win_out, n);
  return cudaGetLastError();
}

}  // namespace

// B12.  src (n, b, b) uint8 contiguous; windows: tile i's (b+7) x (b+7)
// window at windows + i * tile_stride, rows row_stride bytes apart;
// cost (n, 4, 4) int32.  b in {8, 16, 32, 64}.  Launches on `stream` and
// returns cudaGetLastError().
extern "C" int hevc_costmap(const uint8_t* src, const uint8_t* windows, int tile_stride,
                            int row_stride, int32_t* cost, int n, int b, int device,
                            void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n == 0) return cudaGetLastError();
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (b) {
    case 8: return launch_windows<8>(src, windows, tile_stride, row_stride, cost, n, s);
    case 16: return launch_windows<16>(src, windows, tile_stride, row_stride, cost, n, s);
    case 32: return launch_windows<32>(src, windows, tile_stride, row_stride, cost, n, s);
    case 64:
      err = rtc::allow_shared(costmap_ctu_kernel, rtc::SMEM);
      if (err != cudaSuccess) return err;
      costmap_ctu_kernel<<<n, NT, rtc::SMEM, s>>>(src, windows, tile_stride, row_stride, cost);
      return cudaGetLastError();
    default: return cudaErrorInvalidValue;
  }
}

// B13.  src (n, b, b) uint8 contiguous; plane (plane_h, plane_w) uint8
// contiguous, at least (b+7) each way; offsets (n, 2) int32 [y, x] window
// starts, clamped so the window fits; cost (n, 4, 4) int32; win_out
// (n, b+7, b+7) uint8.  b in {8, 16, 32}.
extern "C" int hevc_costmap_dma(const uint8_t* src, const uint8_t* plane,
                                const int32_t* offsets, int32_t* cost, uint8_t* win_out,
                                int n, int b, int plane_h, int plane_w, int device,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (plane_h < b + 7 || plane_w < b + 7) return cudaErrorInvalidValue;
  if (n == 0) return cudaGetLastError();
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (b) {
    case 8: return launch_plane<8>(src, plane, offsets, plane_h, plane_w, cost, win_out, n, s);
    case 16: return launch_plane<16>(src, plane, offsets, plane_h, plane_w, cost, win_out, n, s);
    case 32: return launch_plane<32>(src, plane, offsets, plane_h, plane_w, cost, win_out, n, s);
    default: return cudaErrorInvalidValue;
  }
}
