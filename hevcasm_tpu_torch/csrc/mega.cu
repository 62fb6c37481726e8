// Kernel B19: the whole inter inner loop of a 64x64 CTU in one launch: the
// exhaustive SSD search with its first minimum, the quarter-pel refinement
// at the winner, and the 8x8 residual pipeline.
//
// Replaces hevcasm_tpu/kernels/mega_pallas.py encode_ctu_mega (body
// _mega_kernel).  Per CTU at position (py, px), both windows are read from
// the loop's reference plane padded by R + 3 on the top and left (R + 4 on
// the bottom and right):
//
//   1. the (64 + 2R)^2 search window at (py + 3, px + 3), every displacement
//      (dy, dx) in [0, 2R]^2 scored by exact SSD, the first minimum in
//      row-major [dy, dx] order kept (csrc/search_core.cuh);
//   2. the 71x71 refine window at (py + dy, px + dx), i.e. at the integer MV
//      (dy - R, dx - R), refined by QPEL_SCORE (refine_select of
//      csrc/refine_core.cuh), the winner recomputed;
//   3. residual_core<8> (csrc/residual_core.cuh): 8x8 DCT, quantize, per-TU
//      nnz, dequantize, inverse DCT, add and clip.
//
// Outputs rec (n, 64, 64) uint8, mv (n, 2), frac (n,), best SSD (n,) and nnz
// (n, 8, 8) int32, equal to K1 + first minimum + K2.  No score grid and no
// window reaches device memory between the stages.
//
// What bounds it on the H100: the search's integer work, as for B17
// ((2R+1)^2 * 4096 subtract-multiply-adds a CTU, 17.3 M at R = 32), with
// K2's refinement and residual (about 0.7 M multiply-adds a CTU) after it.
//
// Design: one 256-thread block per CTU that loops over the dy rows (design
// (b) of the two considered).  The whole (64 + 2R)^2 search window (at most
// 128 rows of 140 bytes, 17.5 KB) is staged once in the shared memory that
// the refinement's horizontal passes use afterwards, so the block holds K2's
// 46.7 KB and four blocks share an SM: the 510 CTUs of a 1920x1088 frame run
// in one wave on the 132 SMs.  The 65 x 9 (dy, 8-dx group) tasks at R = 32
// take three passes of the 256 threads; the packed keys meet in one block
// reduction, with no atomics and no second kernel.  The other design, a
// thread-block cluster per CTU with one block per dy slice meeting through
// distributed shared memory, would keep B17's several blocks a CTU but needs a
// cluster launch and a cross-block barrier; it is left for a later
// measurement.  The TPU kernel's (144, 256) slab, its P = R + 8 plane and
// its lane rolls are Mosaic DMA devices and are not carried over.

#include "refine_core.cuh"
#include "search_core.cuh"

namespace {

constexpr int NTU = B / 8;    // 8x8 TUs per CTU side
static_assert(hevc_search::CTU == B, "one CTU size");
static_assert((B + 2 * hevc_search::MAX_R) * hevc_search::WS <= sizeof(RefineSmem::hp),
              "the search window fits in the horizontal passes' buffer");

__global__ void __launch_bounds__(NT)
mega_kernel(const uint8_t* __restrict__ src, const uint8_t* __restrict__ plane,
            const int32_t* __restrict__ positions, uint8_t* __restrict__ rec,
            int32_t* __restrict__ mv_out, int32_t* __restrict__ frac_out,
            int32_t* __restrict__ best_out, int32_t* __restrict__ nnz_out, int plane_h,
            int plane_w, int radius, int qscale, int qshift, int qoffset, int dscale,
            int dshift) {
  using namespace hevc_search;
  // sm.hp holds the search window, then the horizontal passes, then the
  // residual stage's two int32 planes; sm.win the refine window, then the
  // prediction.
  __shared__ RefineSmem sm;
  __shared__ __align__(16) uint8_t s_src[B * B];
  __shared__ int s_nnz[NTU * NTU];
  __shared__ int s_bits[NTU * NTU];
  __shared__ unsigned long long s_red[NT / 32];

  const int i = blockIdx.x;
  const int t = threadIdx.x;
  const int num = 2 * radius + 1;
  const int groups = (num + DXT - 1) / DXT;
  const int wide = B + 2 * radius;
  const int py = positions[2 * i], px = positions[2 * i + 1];

  // ---- 1. search ------------------------------------------------------------
  const uint8_t* s = src + static_cast<size_t>(i) * B * B;
  for (int k = t; k < B * B; k += NT) s_src[k] = s[k];
  // The window start, clamped so the window fits (as the plain version's
  // gather clamps).
  const int oy = clip3(0, plane_h - wide, py + 3);
  const int ox = clip3(0, plane_w - wide, px + 3);
  uint8_t* s_win = reinterpret_cast<uint8_t*>(sm.hp);
  stage_window(plane + static_cast<size_t>(oy) * plane_w + ox, plane_w, 0, wide, wide, s_win);
  __syncthreads();
  unsigned long long key = NO_KEY;
  for (int task = t; task < num * groups; task += NT) {
    const int dy = task / groups, g = task - dy * groups;
    const unsigned long long k = ssd_key8(s_win + dy * WS, s_src, dy, g * DXT, num);
    key = k < key ? k : key;
  }
  key = block_min_key(key, s_red);
  const int idx = static_cast<int>(key & 0xFFFFFFFFull);
  const int dy = idx / num, dx = idx % num;
  if (t == 0) {
    mv_out[2 * i] = dy - radius;
    mv_out[2 * i + 1] = dx - radius;
    best_out[i] = static_cast<int>(key >> 32);
  }

  // ---- 2. refine at the integer MV (dy - R, dx - R) ------------------------
  const int best = refine_select(plane, plane_h, plane_w, py + dy, px + dx, s_src, sm);
  if (t == 0) frac_out[i] = best;
  uint8_t* s_pred = sm.win;  // (B, B), row stride B
  const int x = t % B, yg = t / B;
#pragma unroll 4
  for (int yy = 0; yy < 16; ++yy)
    s_pred[(16 * yg + yy) * B + x] = static_cast<uint8_t>(
        clip3(0, 255, (winner_acc(sm, best, x, yg, yy) + 2048) >> 12));
  __syncthreads();

  // ---- 3. residual ----------------------------------------------------------
  residual_core<8>(s_src, s_pred, reinterpret_cast<int*>(sm.hp), s_nnz, s_bits,
                   rec + static_cast<size_t>(i) * B * B,
                   nnz_out + static_cast<size_t>(i) * NTU * NTU, nullptr, qscale, qshift,
                   qoffset, dscale, dshift);
}

}  // namespace

// src (n, 64, 64) uint8 contiguous; plane (plane_h, plane_w) uint8
// contiguous, the reference padded by R + 3 top/left and R + 4
// bottom/right (at least (64 + 2R) and 71 square); positions (n, 2) int32
// CTU [y, x] in the unpadded frame; outputs rec (n, 64, 64) uint8, mv
// (n, 2), frac (n,), best (n,) and nnz (n, 8, 8) int32.  The caller checks
// the quantizer ranges (1 <= qscale < 2^15, 16 <= qshift <= 27,
// 0 <= qoffset < 2^15, 1 <= dshift <= 31).  Launches on `stream`, returns
// cudaGetLastError() (cudaErrorInvalidValue for 1 > R or R > 32 or a
// plane smaller than a window).
extern "C" int hevc_mega(const uint8_t* src, const uint8_t* plane, const int32_t* positions,
                         uint8_t* rec, int32_t* mv, int32_t* frac, int32_t* best,
                         int32_t* nnz, int n, int plane_h, int plane_w, int radius,
                         int qscale, int qshift, int qoffset, int dscale, int dshift,
                         int device, void* stream) {
  if (radius < 1 || radius > hevc_search::MAX_R) return cudaErrorInvalidValue;
  const int wide = B + 2 * radius;
  if (plane_h < wide || plane_w < wide || plane_h < WIN || plane_w < WIN ||
      qshift < 16 || qshift > 27 || dshift < 1 || dshift > 31)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n == 0) return cudaGetLastError();
  mega_kernel<<<n, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      src, plane, positions, rec, mv, frac, best, nnz, plane_h, plane_w, radius, qscale,
      qshift, qoffset, dscale, dshift);
  return cudaGetLastError();
}
