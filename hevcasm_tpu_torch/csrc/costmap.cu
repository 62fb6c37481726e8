// Kernels B12 and B13: the quarter-pel cost maps of small blocks.
//
// Replaces hevcasm_tpu/kernels/interp_pallas.py refine_qpel_costmap (bodies
// _costmap_kernel_stacked for b <= 32, _costmap_kernel above) and
// refine_qpel_costmap_dma (_costmap_kernel_dma).  For tile i of side B in
// {8, 16, 32, 64} and its (B+7) x (B+7) window anchored at the integer MV:
//
//   cost[i][yf][xf] = sum_{y,x < B} |acc_{yf,xf}(y, x) - (src[i][y][x] << 12)| >> 4
//
// where acc is the pre-clip vertical 8-tap accumulation over the four
// horizontal passes, each wrapped to int16 (ops/pred_inter.qpel_costmap).
// Every term is below 2^18, so a 64x64 sum stays below 2^30.  There is no
// selection and no prediction: the PU decision sums the maps of a PU's
// tiles and picks one fraction per PU (encode/partition.py).
//
// Two C entries share the device core: hevc_costmap reads windows the
// caller gathered (B12); hevc_costmap_dma reads each window from the plane
// at its offset, clamped so it fits as motion.extract_windows clamps, and
// also writes the window out for the chosen-fraction interpolation (B13).
//
// What bounds it on the H100: latency, not arithmetic or bandwidth.  The
// 8160 16x16 tiles of a 1080p PU decision are ~0.4 G multiply-adds and
// ~6 MB of windows and sources; each tile is small, its window rows are
// scattered over the plane, and a 16x16 tile is too little work for a
// block.
//
// Design: one block of 256 threads holds 256 / (B * B / ROWS) tiles (1 at
// B = 64, 2 at 32, 8 at 16, 32 at 8), so every block has the same thread
// count and enough tiles to hide the window fetch.  Each tile's window and
// source are staged in shared memory, its four int16 horizontal passes are
// kept there (the K2 layout of csrc/refine_core.cuh, generalised to B),
// and each thread owns one column and ROWS rows of one tile and sums all 16
// candidates for them in registers.  The threads of a tile are contiguous
// lanes, so the per-tile sum is a shuffle reduction (plus one step through
// shared memory where a tile spans several warps).  K2's and B3's sources
// are not touched.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;                 // threads per block

// HEVC luma quarter-pel filters, KERNEL8[frac][tap].
__constant__ int K8[4][8] = {
    {0, 0, 0, 64, 0, 0, 0, 0},
    {-1, 4, -10, 58, 17, -5, 1, 0},
    {-1, 4, -11, 40, 40, -11, 4, -1},
    {0, 1, -5, 17, 58, -10, 4, -1},
};

__device__ __forceinline__ int wrap16(int v) {
  return static_cast<int>(static_cast<int16_t>(static_cast<uint16_t>(v & 0xFFFF)));
}

__device__ __forceinline__ int clip3(int lo, int hi, int v) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Where a tile's window comes from: gathered windows (tile i at
// windows + i * tile_stride, rows row_stride apart), or the plane at
// offsets[i] (then win_out receives the (B+7)^2 window).
struct WindowSource {
  const uint8_t* windows;
  long long tile_stride;
  int row_stride;
  const uint8_t* plane;
  const int32_t* offsets;
  int plane_h, plane_w;
  uint8_t* win_out;
};

template <int B, bool FROM_PLANE>
__global__ void __launch_bounds__(NT)
costmap_kernel(const uint8_t* __restrict__ src, WindowSource ws,
               int32_t* __restrict__ cost, int n) {
  constexpr int ROWS = B == 64 ? 16 : 8;          // rows per thread
  constexpr int TPT = B * (B / ROWS);             // threads per tile
  constexpr int TILES = NT / TPT;                 // tiles per block
  constexpr int WIN = B + 7;
  constexpr int WSTR = B + 8;                     // window row stride
  static_assert(TILES * TPT == NT, "tiles must fill the block");

  __shared__ __align__(16) uint8_t s_win[TILES][WIN * WSTR];
  __shared__ __align__(16) int16_t s_hp[TILES][4 * WIN * B];   // [xf][r][c]
  __shared__ __align__(16) uint8_t s_src[TILES][B * B];
  __shared__ int s_org[TILES][2];
  __shared__ int s_red[NT / 32][16];

  const int t = threadIdx.x;
  const int tile0 = blockIdx.x * TILES;
  const int ntiles = min(TILES, n - tile0);

  // ---- 1. windows and sources ---------------------------------------------
  if (FROM_PLANE && t < ntiles) {
    s_org[t][0] = clip3(0, ws.plane_h - WIN, ws.offsets[2 * (tile0 + t)]);
    s_org[t][1] = clip3(0, ws.plane_w - WIN, ws.offsets[2 * (tile0 + t) + 1]);
  }
  __syncthreads();
  for (int k = t; k < ntiles * WIN * WIN; k += NT) {
    const int j = k / (WIN * WIN);
    const int rem = k - j * WIN * WIN;
    const int r = rem / WIN, c = rem - r * WIN;
    const size_t i = static_cast<size_t>(tile0 + j);
    uint8_t v;
    if (FROM_PLANE) {
      v = ws.plane[static_cast<size_t>(s_org[j][0] + r) * ws.plane_w + s_org[j][1] + c];
      ws.win_out[i * WIN * WIN + rem] = v;
    } else {
      v = ws.windows[i * ws.tile_stride + static_cast<size_t>(r) * ws.row_stride + c];
    }
    s_win[j][r * WSTR + c] = v;
  }
  const uint8_t* s = src + static_cast<size_t>(tile0) * B * B;
  for (int k = t; k < ntiles * B * B; k += NT) {
    const int j = k / (B * B);
    s_src[j][k - j * B * B] = s[k];
  }
  __syncthreads();

  // ---- 2. horizontal passes: s_hp[j][xf][r][c], int16-wrapped --------------
  for (int k = t; k < ntiles * 4 * WIN * B; k += NT) {
    const int j = k / (4 * WIN * B);
    const int rem = k - j * 4 * WIN * B;
    const int xf = rem / (WIN * B);
    const int rc = rem - xf * WIN * B;
    const int r = rc / B, c = rc - r * B;
    const uint8_t* w = &s_win[j][r * WSTR + c];
    int v = 0;
#pragma unroll
    for (int tap = 0; tap < 8; ++tap) v += K8[xf][tap] * w[tap];
    s_hp[j][rem] = static_cast<int16_t>(wrap16(v));
  }
  __syncthreads();

  // ---- 3. vertical accumulations + QPEL_SCORE ------------------------------
  // Thread t owns tile j, column x and the rows [ROWS*yg, ROWS*yg + ROWS).
  const int j = t / TPT;
  const int lt = t - j * TPT;
  const int x = lt % B, yg = lt / B;
  int acc16[16];
#pragma unroll
  for (int c = 0; c < 16; ++c) acc16[c] = 0;
  if (j < ntiles) {
#pragma unroll
    for (int xf = 0; xf < 4; ++xf) {
      int col[ROWS + 7];
      const int16_t* hp = &s_hp[j][(xf * WIN + ROWS * yg) * B + x];
#pragma unroll
      for (int r = 0; r < ROWS + 7; ++r) col[r] = hp[r * B];
#pragma unroll
      for (int yy = 0; yy < ROWS; ++yy) {
        const int s12 = static_cast<int>(s_src[j][(ROWS * yg + yy) * B + x]) << 12;
#pragma unroll
        for (int yf = 0; yf < 4; ++yf) {
          int acc = 0;
#pragma unroll
          for (int tap = 0; tap < 8; ++tap) acc += K8[yf][tap] * col[yy + tap];
          acc16[yf * 4 + xf] += abs(acc - s12) >> 4;
        }
      }
    }
  }

  // ---- 4. the per-tile sum --------------------------------------------------
  // A tile's threads are TPT contiguous lanes; xor shuffles below TPT stay
  // inside them.  Every thread of the block takes part (inactive tiles add 0).
  constexpr int LANES = TPT < 32 ? TPT : 32;
#pragma unroll
  for (int c = 0; c < 16; ++c) {
    int v = acc16[c];
#pragma unroll
    for (int off = LANES / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    acc16[c] = v;
  }
  if constexpr (TPT <= 32) {
    if (lt == 0 && j < ntiles) {
      int32_t* o = cost + static_cast<size_t>(tile0 + j) * 16;
#pragma unroll
      for (int c = 0; c < 16; ++c) o[c] = acc16[c];
    }
  } else {
    constexpr int WPT = TPT / 32;                 // warps per tile
    if ((t & 31) == 0) {
#pragma unroll
      for (int c = 0; c < 16; ++c) s_red[t >> 5][c] = acc16[c];
    }
    __syncthreads();
    if (t < TILES * 16) {
      const int jj = t / 16, c = t % 16;
      if (jj < ntiles) {
        int v = 0;
#pragma unroll
        for (int w = 0; w < WPT; ++w) v += s_red[jj * WPT + w][c];
        cost[static_cast<size_t>(tile0 + jj) * 16 + c] = v;
      }
    }
  }
}

template <int B, bool FROM_PLANE>
cudaError_t launch(const uint8_t* src, const WindowSource& ws, int32_t* cost, int n,
                   cudaStream_t stream) {
  constexpr int ROWS = B == 64 ? 16 : 8;
  constexpr int TILES = NT / (B * (B / ROWS));
  const int blocks = (n + TILES - 1) / TILES;
  costmap_kernel<B, FROM_PLANE><<<blocks, NT, 0, stream>>>(src, ws, cost, n);
  return cudaGetLastError();
}

template <bool FROM_PLANE>
cudaError_t dispatch(int b, const uint8_t* src, const WindowSource& ws, int32_t* cost,
                     int n, cudaStream_t stream) {
  switch (b) {
    case 8: return launch<8, FROM_PLANE>(src, ws, cost, n, stream);
    case 16: return launch<16, FROM_PLANE>(src, ws, cost, n, stream);
    case 32: return launch<32, FROM_PLANE>(src, ws, cost, n, stream);
    case 64:
      if (!FROM_PLANE) return launch<64, false>(src, ws, cost, n, stream);
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
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
  WindowSource ws{windows, tile_stride, row_stride, nullptr, nullptr, 0, 0, nullptr};
  return dispatch<false>(b, src, ws, cost, n, static_cast<cudaStream_t>(stream));
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
  WindowSource ws{nullptr, 0, 0, plane, offsets, plane_h, plane_w, win_out};
  return dispatch<true>(b, src, ws, cost, n, static_cast<cudaStream_t>(stream));
}
