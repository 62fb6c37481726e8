// Kernels B14 and B15: the sub-block SSD grids of every CTU, and the per-PU
// first minimum over them.
//
// Replace hevcasm_tpu/kernels/search_pallas.py base_grids_ctu and
// base_layout_decide (both _base_grids_kernel).  For CTU i, sub-block (p, q)
// of side BASE in {8, 16, 32} (k = 64 / BASE per side) and displacement
// (dy, dx) in [0, 2R]^2 of its (64 + 2R)^2 search window:
//
//   grid[i][p][q][dy][dx] = sum_{y,x < BASE} (win[i][BASE*p + dy + y][BASE*q + dx + x]
//                                              - src[i][BASE*p + y][BASE*q + x])^2
//
// in exact int32 (a whole CTU sums below 4096 * 255^2 < 2^31).  B14 writes
// the grids, (n, k, k, 2R+1, 2R+1) in [dy, dx] order.  B15 takes a list of
// PUs, each a list of distinct sub-blocks, sums each PU's sub-block grids
// and keeps its first minimum in row-major [dy, dx] order: (n, P, 3) int32
// [dy - R, dx - R, ssd].  R is a runtime argument, 1 <= R <= 32.
//
// What bounds it on the H100: integer work, as for K1 (csrc/ssd_grid_plane.cu):
// (2R+1)^2 * 4096 subtract-multiply-adds per CTU, 8.8 G for a 1920x1088
// frame at R = 32, on the CUDA cores' int32 pipes.  The grids are 138 MB a
// frame at BASE 16 and 552 MB at BASE 8, written once and read once.
//
// Design: the grid core of csrc/grid_core.cuh (the CUDA-core design K1
// had before its tensor-core form, with one int32 sum per sub-block
// column: k x 8 registers a thread, 64 at BASE 8), run over the (64 +
// 2R)^2 CTU windows.  B15 runs the grid kernel into a
// scratch buffer, then a decide kernel: one thread per
// (CTU, candidate) gathers its k*k sub-block values into its own column of
// shared memory, adds each PU's members, and packs (ssd << 32 | dy * (2R+1)
// + dx) into a uint64 whose plain unsigned minimum is the row-major first
// minimum; warp shuffles and one step through shared memory reduce a block
// to one atomicMin per PU on a per-(CTU, PU) key, and a third small kernel
// decodes the keys.  Keeping the grids of a slice in shared memory instead
// (a first version) left four 96-thread blocks per SM and took 1.7 ms for a
// 1920x1088 frame at BASE 16 on an H100 (700 W), against 1.2 ms for this
// design and 0.9 ms for the grids alone.  The TPU kernel's
// centred sum s^2 + box - 2 corr form, band matrices and packed rolls are
// Mosaic devices; the SSD is computed directly.

#include <cuda_runtime.h>
#include <stdint.h>

#include "grid_core.cuh"

namespace {

constexpr int CTU = 64;
constexpr int MAX_R = 32;
constexpr int WS = 140;    // staged window row: 8 * 9 + 64 bytes, 35 words

// B15's decide step.  Block (x, i) holds candidates [x * blockDim.x, ...)
// of CTU i.  pu_table: offsets[num_pu + 1], then the sub-block indices of
// every PU.  Dynamic shared memory: kk int32 per thread, then num_pu uint64
// per warp.
__global__ void __launch_bounds__(256)
decide_kernel(const int32_t* __restrict__ grids, int kk, int cands,
              const int32_t* __restrict__ pu_table, int num_pu,
              unsigned long long* __restrict__ keys) {
  extern __shared__ __align__(16) unsigned char s_raw[];
  const int nt = blockDim.x;
  const int warps = nt / 32;
  int32_t* s_v = reinterpret_cast<int32_t*>(s_raw);                    // [kk][nt]
  unsigned long long* s_min =
      reinterpret_cast<unsigned long long*>(s_raw + static_cast<size_t>(kk) * nt * 4);

  const int t = threadIdx.x;
  const int ctu = blockIdx.y;
  const int c = blockIdx.x * nt + t;
  const bool live = c < cands;
  const int32_t* g = grids + static_cast<size_t>(ctu) * kk * cands;
  // Each thread reads back only its own column: no barrier needed here.
  for (int s = 0; s < kk; ++s) s_v[s * nt + t] = live ? g[static_cast<size_t>(s) * cands + c] : 0;

  const int32_t* members = pu_table + num_pu + 1;
  for (int pu = 0; pu < num_pu; ++pu) {
    unsigned long long key = ~0ull;
    if (live) {
      int v = 0;
      for (int m = pu_table[pu]; m < pu_table[pu + 1]; ++m) v += s_v[members[m] * nt + t];
      key = (static_cast<unsigned long long>(static_cast<uint32_t>(v)) << 32)
            | static_cast<uint32_t>(c);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const unsigned long long o = __shfl_xor_sync(0xffffffffu, key, off);
      key = o < key ? o : key;
    }
    if ((t & 31) == 0) s_min[pu * warps + (t >> 5)] = key;
  }
  __syncthreads();
  for (int pu = t; pu < num_pu; pu += nt) {
    unsigned long long key = ~0ull;
    for (int wi = 0; wi < warps; ++wi) {
      const unsigned long long o = s_min[pu * warps + wi];
      key = o < key ? o : key;
    }
    if (key != ~0ull) atomicMin(&keys[static_cast<size_t>(ctu) * num_pu + pu], key);
  }
}

__global__ void decode_keys_kernel(const unsigned long long* __restrict__ keys,
                                   int32_t* __restrict__ out, int count, int num,
                                   int radius) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  const unsigned long long key = keys[i];
  const int idx = static_cast<int>(key & 0xFFFFFFFFull);
  out[3 * i] = idx / num - radius;
  out[3 * i + 1] = idx % num - radius;
  out[3 * i + 2] = static_cast<int>(key >> 32);
}

// The grid kernel over n CTUs and their (64 + 2R)^2 windows.
cudaError_t launch_grids(int base, int n, int radius, cudaStream_t stream,
                         const uint8_t* src, const uint8_t* windows, int ctu_stride,
                         int row_stride, int32_t* grids) {
  const int num = 2 * radius + 1;
  const int wide = CTU + 2 * radius;
  switch (base) {
    case 8:
      return hevc_grid::launch_grid<CTU, 8, WS>(n, src, windows, ctu_stride, row_stride, wide,
                                            wide, num, num, grids, stream);
    case 16:
      return hevc_grid::launch_grid<CTU, 16, WS>(n, src, windows, ctu_stride, row_stride, wide,
                                             wide, num, num, grids, stream);
    case 32:
      return hevc_grid::launch_grid<CTU, 32, WS>(n, src, windows, ctu_stride, row_stride, wide,
                                             wide, num, num, grids, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// B14.  src (n, 64, 64) uint8 contiguous; windows: CTU i's (64 + 2R)^2
// window at windows + i * ctu_stride, rows row_stride bytes apart; grids
// (n, k, k, 2R+1, 2R+1) int32.  Launches on `stream` and returns
// cudaGetLastError().
extern "C" int hevc_base_grids(const uint8_t* src, const uint8_t* windows, int ctu_stride,
                               int row_stride, int32_t* grids, int n, int base, int radius,
                               int device, void* stream) {
  if (radius < 1 || radius > MAX_R) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n == 0) return cudaGetLastError();
  return launch_grids(base, n, radius, static_cast<cudaStream_t>(stream), src, windows,
                      ctu_stride, row_stride, grids);
}

// B15.  src and windows as for B14; pu_table int32 [offsets (num_pu + 1),
// sub-block indices]; grids (n, k, k, 2R+1, 2R+1) int32 and keys
// (n, num_pu) uint64 scratch; out (n, num_pu, 3) int32 [dy - R, dx - R,
// ssd].  Four operations on `stream`: the keys are set to ~0, the grid
// kernel fills the scratch grids, the decide kernel keeps each PU's
// minimum, the decode kernel writes out.
extern "C" int hevc_base_decide(const uint8_t* src, const uint8_t* windows, int ctu_stride,
                                int row_stride, const int32_t* pu_table, int num_pu,
                                int32_t* grids, unsigned long long* keys, int32_t* out,
                                int n, int base, int radius, int device, void* stream) {
  if (radius < 1 || radius > MAX_R || num_pu < 1) return cudaErrorInvalidValue;
  if (base != 8 && base != 16 && base != 32) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n == 0) return cudaGetLastError();
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int num = 2 * radius + 1;
  const int k = CTU / base;
  const size_t count = static_cast<size_t>(n) * num_pu;
  err = cudaMemsetAsync(keys, 0xFF, count * sizeof(unsigned long long), s);
  if (err != cudaSuccess) return err;
  err = launch_grids(base, n, radius, s, src, windows, ctu_stride, row_stride, grids);
  if (err != cudaSuccess) return err;
  // 256 threads a block, 128 at BASE 8 so its 64 values a thread fit.
  const int threads = k * k > 16 ? 128 : 256;
  const size_t smem = static_cast<size_t>(k) * k * threads * 4
                      + static_cast<size_t>(num_pu) * (threads / 32) * 8;
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  const dim3 grid((num * num + threads - 1) / threads, n);
  decide_kernel<<<grid, threads, smem, s>>>(grids, k * k, num * num, pu_table, num_pu, keys);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_keys_kernel<<<static_cast<unsigned>((count + 255) / 256), 256, 0, s>>>(
      keys, out, static_cast<int>(count), num, radius);
  return cudaGetLastError();
}
