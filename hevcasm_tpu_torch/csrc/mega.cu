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
//      row-major [dy, dx] order kept (csrc/ssd_tc_core.cuh, as B17);
//   2. the 71x71 refine window at (py + dy, px + dx), i.e. at the integer MV
//      (dy - R, dx - R), refined by QPEL_SCORE (refine_select of
//      csrc/refine_core.cuh), the winner recomputed;
//   3. residual_ctu8 (csrc/residual_core.cuh): 8x8 DCT, quantize, per-TU
//      nnz, dequantize, inverse DCT, add and clip, the transform passes on
//      mma.sync.
//
// Outputs rec (n, 64, 64) uint8, mv (n, 2), frac (n,), best SSD (n,) and nnz
// (n, 8, 8) int32, equal to K1 + first minimum + K2.  No score grid and no
// window reaches device memory between the stages.
//
// What bounds it on the H100: the search's correlation, 4096 (2R+1)^2
// multiply-adds a CTU (17.3 M at R = 32) on the int8 tensor cores, as for
// K1 and B17, with K2's refinement and residual (about 0.7 M multiply-adds
// a CTU) after it.
//
// Design: one 256-thread block per CTU (refine_core and residual_ctu8 want
// NT = 256), 71 KB of shared memory and at most 128 registers a thread, so
// two blocks share an SM and the 510 CTUs of a 1920x1088 frame take two
// waves of 264 (K1's five warps hold 36 accumulators a thread at up to 102
// registers; four 256-thread blocks an SM would allow 64).  Stage 1 is
// csrc/ssd_tc_core.cuh's whole-CTU search: all 256 threads stage the CTU
// (its words stay in shared memory for stages 2 and 3), Z, S and the
// window; then warps 0-4 run the products (warp m the dy rows 16m .. 16m +
// 15) while warps 5-7 compute E for all 2R + 1 dy rows at once, meeting at
// a named barrier of their own, so that E overlaps the products.  The
// keyed epilogue is B17's: packed keys (SSD << 32 | dy (2R+1) + dx) for dy,
// dx < 2R + 1 only, reduced by shuffles and through shared memory, and the
// winner reaches every thread through shared memory.  The search's window,
// Z rows and E share their memory with the refinement's (a union).  The TPU
// kernel's (144, 256) slab, its P = R + 8 plane and its lane rolls are
// Mosaic DMA devices and are not carried over.

#include "refine_core.cuh"
#include "ssd_tc_core.cuh"

namespace {

constexpr int NTU = B / 8;                        // 8x8 TUs per CTU side
constexpr int PRODUCT_WARPS = hevc_tc::MAX_MT;    // warps 0-4: the products
constexpr int E_FIRST = 32 * PRODUCT_WARPS;       // warps 5-7: E
static_assert(hevc_tc::CTU == B && NT > E_FIRST, "one CTU size; warps left for E");

struct SearchSmem {
  // s_z must follow the window: the m16 tiles read rows past it.
  __align__(16) uint8_t win[hevc_tc::WIN_SMEM];
  uint2 z[hevc_tc::CTU * hevc_tc::ZW];
  int32_t e[hevc_tc::MAX_NUM * hevc_tc::E_STRIDE];
};

struct MegaSmem {
  union {
    SearchSmem search;     // stage 1
    RefineSmem refine;     // stages 2 and 3
  };
  __align__(16) uint8_t src[B * B];
  unsigned long long keys[NT / 32];
  int32_t red[NT / 32];
};

__global__ void __launch_bounds__(NT, 2)
mega_kernel(const uint8_t* __restrict__ src, const uint8_t* __restrict__ plane,
            const int32_t* __restrict__ positions, uint8_t* __restrict__ rec,
            int32_t* __restrict__ mv_out, int32_t* __restrict__ frac_out,
            int32_t* __restrict__ best_out, int32_t* __restrict__ nnz_out, int plane_h,
            int plane_w, int radius, int qscale, int qshift, int qoffset, int dscale,
            int dshift) {
  extern __shared__ __align__(128) uint8_t smem[];
  MegaSmem& m = *reinterpret_cast<MegaSmem*>(smem);
  const int i = blockIdx.x;
  const int t = threadIdx.x, warp = t >> 5;
  const int num = 2 * radius + 1;
  const int wide = B + 2 * radius;
  const int mt_count = (num + 15) / 16, nt_count = (num + 7) / 8;
  const int ks_count = (wide + 31) / 32;
  const int py = positions[2 * i], px = positions[2 * i + 1];

  // ---- 1. search ------------------------------------------------------------
  const int s_total = hevc_tc::stage_source<NT>(src + static_cast<size_t>(i) * B * B,
                                                reinterpret_cast<uint32_t*>(m.src),
                                                m.search.z, m.red);
  // The window start, clamped so the window fits (as the plain version's
  // gather clamps).
  const int oy = clip3(0, plane_h - wide, py + 3);
  const int ox = clip3(0, plane_w - wide, px + 3);
  hevc_tc::stage_window<NT>(plane + static_cast<size_t>(oy) * plane_w + ox, plane_w, wide,
                            m.search.win);
  __syncthreads();
  int acc[hevc_tc::MAX_NT][4];
  if (warp < PRODUCT_WARPS) {
    if (warp < mt_count)
      hevc_tc::tc_products(acc, m.search.win, m.search.z, warp, ks_count, nt_count);
  } else {
    hevc_tc::window_energy(m.search.win, m.search.e, 0, num, wide, num, t - E_FIRST,
                           NT - E_FIRST, hevc_tc::NamedSync<1, NT - E_FIRST>());
  }
  __syncthreads();
  unsigned long long key = hevc_tc::NO_SSD_KEY;
  if (warp < mt_count)
    hevc_tc::for_each_candidate(acc, warp, num, [&](int dy, int dx, int c) {
      key = hevc_tc::min_key(
          key, hevc_tc::ssd_key(s_total + m.search.e[dy * hevc_tc::E_STRIDE + dx] - 2 * c,
                                dy * num + dx));
    });
  // The barrier inside also ends every read of the search's memory.
  key = hevc_tc::block_min_key(key, m.keys);
  const int idx = static_cast<int>(key & 0xFFFFFFFFull);
  const int dy = idx / num, dx = idx % num;
  if (t == 0) {
    mv_out[2 * i] = dy - radius;
    mv_out[2 * i + 1] = dx - radius;
    best_out[i] = static_cast<int>(key >> 32);
  }

  // ---- 2. refine at the integer MV (dy - R, dx - R) ------------------------
  const int best = refine_select(plane, plane_h, plane_w, py + dy, px + dx, m.src, m.refine);
  if (t == 0) frac_out[i] = best;
  uint8_t* s_pred = m.refine.win;  // (B, B), row stride B
  const int x = t % B, yg = t / B;
#pragma unroll 4
  for (int yy = 0; yy < 16; ++yy)
    s_pred[(16 * yg + yy) * B + x] = static_cast<uint8_t>(
        clip3(0, 255, (winner_acc(m.refine, best, x, yg, yy) + 2048) >> 12));
  __syncthreads();

  // ---- 3. residual ----------------------------------------------------------
  residual_ctu8(m.src, s_pred, rec + static_cast<size_t>(i) * B * B,
                nnz_out + static_cast<size_t>(i) * NTU * NTU, nullptr,
                {qscale, qshift, qoffset, dscale, dshift});
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
  if (radius < 1 || radius > hevc_tc::MAX_R) return cudaErrorInvalidValue;
  const int wide = B + 2 * radius;
  if (plane_h < wide || plane_w < wide || plane_h < WIN || plane_w < WIN ||
      qshift < 16 || qshift > 27 || dshift < 1 || dshift > 31)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n == 0) return cudaGetLastError();
  err = cudaFuncSetAttribute(mega_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(sizeof(MegaSmem)));
  if (err != cudaSuccess) return err;
  mega_kernel<<<n, NT, sizeof(MegaSmem), static_cast<cudaStream_t>(stream)>>>(
      src, plane, positions, rec, mv, frac, best, nnz, plane_h, plane_w, radius, qscale,
      qshift, qoffset, dscale, dshift);
  return cudaGetLastError();
}
