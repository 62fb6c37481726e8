// Kernel B17: the exhaustive SSD search of 64x64 CTUs with the first minimum
// taken in the kernel's epilogue, so the (2R+1)^2 score grids never leave
// the block.
//
// Replaces hevcasm_tpu/kernels/search_pallas.py search_mv (body
// _kernel_chunked_mv, windows gathered by the caller) and search_mv_dma
// (body _search_kernel_dma, windows read from the padded reference plane):
// one C entry serves both, since each reads CTU i's (64 + 2R)^2 window at a
// per-CTU (row, col) offset into a plane.  search_mv_dma passes the loop's
// padded reference, the CTU positions and a shift of PAD_L; search_mv
// passes the contiguous stack of n gathered windows viewed as a plane of n
// * Wh rows, window i at (i * Wh, 0), and a shift of 0.  Output per CTU: mv = [dy - R, dx - R] and the
// best SSD of the first minimum in row-major [dy, dx] order, the result of
// motion.full_search.
//
// What bounds it on the H100: the correlation, 4096 (2R+1)^2 multiply-adds
// a CTU (17.3 M at R = 32, 8.8 G for a 1920x1088 frame), as for K1
// (csrc/ssd_grid_plane.cu).  On the CUDA cores' int32 pipes, where this
// kernel ran until it took K1's core, that is ~10 T terms/s, about 1% of
// the card; on the int8 tensor cores the bound is 0.009 ms a frame.  Unlike
// K1 it writes no grid (K1's 8.6 MB a frame): 12 bytes a CTU.
//
// Design: K1's block, one launch.  One block per CTU, five warps, 51 KB of
// shared memory and at most 102 registers a thread, so that four blocks
// share an SM and the 510 CTUs of a 1080p frame run in one wave of 528.
// The block runs csrc/ssd_tc_core.cuh's whole-CTU search: the CTU staged
// once (its words, Z and S), the window at the CTU's offset (clamped so it
// fits, as the plain version's gather clamps) staged with rows 144 bytes
// apart, C on mma.sync m16n8k32 u8 with warp m owning dy rows 16m .. 16m +
// 15, and E in two parts (dy rows 0-31, then 32-2R) in 17 KB.  Its
// epilogue turns each lane's S + E - 2C values into packed keys (SSD << 32
// | dy (2R+1) + dx), for dy, dx < 2R + 1 only (the tiles' padded rows and
// columns never enter a key), and keeps their minimum; warp shuffles and
// one step through shared memory reduce the block to one key, and thread 0
// writes mv and best.  No key scratch, memset, atomic or second kernel.
// The TPU kernels' chunked-K matmuls, band matrices, slab DMAs and lane
// rolls are Mosaic devices and are not carried over.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ssd_tc_core.cuh"

namespace {

using namespace hevc_tc;

constexpr int WARPS = MAX_MT;
constexpr int THREADS = 32 * WARPS;
constexpr int H_BYTES = (E_HALF * E_STRIDE * 4 + 127) / 128 * 128;   // 17152
constexpr int SMEM = WIN_SMEM + Z_BYTES + H_BYTES + 8 * WARPS;
static_assert(CTU * CTU <= H_BYTES, "the source is staged in the E buffer");

__global__ void __launch_bounds__(THREADS, 4)
search_mv_kernel(const uint8_t* __restrict__ src, const uint8_t* __restrict__ plane,
                 const int32_t* __restrict__ offsets, int shift, int plane_h, int plane_w,
                 int radius, int32_t* __restrict__ mv, int32_t* __restrict__ best) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* s_win = smem;
  uint2* s_z = reinterpret_cast<uint2*>(smem + WIN_SMEM);
  int32_t* s_h = reinterpret_cast<int32_t*>(smem + WIN_SMEM + Z_BYTES);
  unsigned long long* s_keys =
      reinterpret_cast<unsigned long long*>(smem + WIN_SMEM + Z_BYTES + H_BYTES);

  const int num = 2 * radius + 1;
  const int wide = CTU + 2 * radius;
  const int mt_count = (num + 15) / 16, nt_count = (num + 7) / 8;
  const int ks_count = (wide + 31) / 32;
  const int ctu = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5;

  // The CTU (its words in the E buffer, Z and S; s_keys holds S's partial
  // sums until the epilogue), then its window.
  const int s_total = stage_source<THREADS>(src + static_cast<size_t>(ctu) * CTU * CTU,
                                            reinterpret_cast<uint32_t*>(s_h), s_z,
                                            reinterpret_cast<int32_t*>(s_keys));
  const int oy = min(max(offsets[2 * ctu] + shift, 0), plane_h - wide);
  const int ox = min(max(offsets[2 * ctu + 1] + shift, 0), plane_w - wide);
  stage_window<THREADS>(plane + static_cast<size_t>(oy) * plane_w + ox, plane_w, wide, s_win);
  __syncthreads();

  int acc[MAX_NT][4];
  if (warp < mt_count) tc_products(acc, s_win, s_z, warp, ks_count, nt_count);

  // E and the keyed epilogue for warps 0-1 (dy rows 0..31), then for warps
  // 2-4 (dy rows 32..2R).
  unsigned long long key = NO_SSD_KEY;
  for (int part = 0; part < 2; ++part) {
    const int d0 = 32 * part, rows = min(part ? E_HALF : 32, num - d0);
    if (rows <= 0) break;
    __syncthreads();   // the products, or the first part's epilogue, are done
    window_energy(s_win, s_h, d0, rows, wide, num, tid, THREADS, BlockSync());
    __syncthreads();
    if (warp < mt_count && (warp >= 2) == (part == 1))
      for_each_candidate(acc, warp, num, [&](int dy, int dx, int c) {
        key = min_key(key, ssd_key(s_total + s_h[(dy - d0) * E_STRIDE + dx] - 2 * c,
                                   dy * num + dx));
      });
  }
  key = block_min_key(key, s_keys);
  if (tid == 0) {
    const int idx = static_cast<int>(key & 0xFFFFFFFFull);
    mv[2 * ctu] = idx / num - radius;
    mv[2 * ctu + 1] = idx % num - radius;
    best[ctu] = static_cast<int>(key >> 32);
  }
}

}  // namespace

// src (n, 64, 64) uint8 contiguous; plane (plane_h, plane_w) uint8
// contiguous, at least (64 + 2R) square; offsets (n, 2) int32 and shift:
// window i's top-left is offsets[i] + shift in both axes (a start past the
// plane's end is clamped so the window fits); outputs mv (n, 2) and best
// (n,) int32.  One kernel on `stream`, nothing else.
// Returns cudaGetLastError() (cudaErrorInvalidValue for 1 > R or R > 32 or
// a plane smaller than one window).
extern "C" int hevc_search_mv(const uint8_t* src, const uint8_t* plane, const int32_t* offsets,
                              int shift, int32_t* mv, int32_t* best, int n, int plane_h,
                              int plane_w, int radius, int device, void* stream) {
  if (radius < 1 || radius > MAX_R) return cudaErrorInvalidValue;
  const int wide = CTU + 2 * radius;
  if (plane_h < wide || plane_w < wide) return cudaErrorInvalidValue;
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n == 0) return cudaGetLastError();
  err = cudaFuncSetAttribute(search_mv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM);
  if (err != cudaSuccess) return err;
  search_mv_kernel<<<n, THREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(
      src, plane, offsets, shift, plane_h, plane_w, radius, mv, best);
  return cudaGetLastError();
}
