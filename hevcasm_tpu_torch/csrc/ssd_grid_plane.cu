// Kernels K1 and B7: exact SSD grids of 64x64 CTUs, windows read from one
// reference plane (K1) or from each of k planes (B7).
//
// K1 replaces hevcasm_tpu/kernels/search_pallas.py ssd_grid_plane (body
// _kernel_slab), B7 ssd_grid_plane_multi (body _kernel_slab_multi).  For
// CTU i = (r, c) of a grid gc wide, plane p and every integer displacement
// (dy, dx) in [0, 2R]^2, with s the CTU and w its window plane_p[64r :, 64c :]:
//
//   out[i][p][dy][dx] = sum_{y,x < 64} (w[dy + y][dx + x] - s[y][x])^2
//                     = S + E[dy][dx] - 2 C[dy][dx]
//   S = sum s^2,  E[dy][dx] = sum_{y,x < 64} w[dy + y][dx + x]^2,
//   C[dy][dx] = sum_{y < 64} sum_j A_y[dy][j] B_y[j][dx],
//   A_y[dy][j] = w[y + dy][j],  B_y[j][dx] = s[y][j - dx] (0 outside 0..63)
//
// in exact int32 (C, S and E are at most 4096 * 255^2 and S + E < 2^31), for
// any radius 1 <= R <= 32 and any grid width.  Each plane is a reference
// padded by R on the top and left; K1 is the case k = 1.
//
// What bounds it on the H100: the correlation C, 4096 (2R+1)^2 multiply-adds
// a CTU and plane (17.3 M at R = 32).  On the CUDA cores' int32 pipes that
// is ~10 T terms/s, about 1% of the card; this design runs C on the int8
// tensor cores (mma.sync m16n8k32 u8 x u8 -> s32, exact, no centring since
// the operands are unsigned), and S and E, which cost 4096 + ~4 (64 + 2R)^2
// additions, on the CUDA cores.
//
// Design: one block per CTU, five warps, 51 KB of shared memory and at
// most 102 registers a thread, so that four blocks share an SM and the 510
// CTUs of a 1080p frame run in one wave of 528 (at three a SM, the second
// wave's lone blocks cost almost a wave again).  The block stages the CTU
// once, as zero-padded rows packed into word pairs, and for each plane in
// turn the window, 64 + 2R rows zero-padded to 32 KS bytes (MT =
// ceil((2R+1) / 16) m16 tiles of dy, KS = ceil((64 + 2R) / 32) k32 steps of
// window columns, NT = ceil((2R+1) / 8) n8 tiles of dx), eight words a
// thread in flight, rows 144 bytes apart (a multiple of 16 for ldmatrix and
// not of 128, so its eight row reads hit eight bank groups).  Warp m owns
// the dy rows 16m..16m+15 and all NT accumulator tiles (36 registers at R =
// 32).  For each source row y it loads A_y's fragments straight from the
// staged window with ldmatrix (row y + dy: a row offset, no copy; the
// padded dy rows read past the window, into other shared memory) and
// builds B_y's in registers: B_y depends on j - dx only, so a lane needs 10
// words of the padded source row, each one 8-byte shared load and a funnel
// shift, loaded a row ahead (the staging, the products, E and the epilogue's
// lane layout are csrc/ssd_tc_core.cuh's, shared with B17 and B19; B15
// shares the fragments).  The fragment of k step ks and n tile nt is
// zero unless 32 ks - 8 nt lies in [-24, 64]; the other steps are skipped,
// which keeps the tensor work at 26 of 36 (k step, n tile) pairs a warp,
// about twice the useful multiply-adds.  E is a separable running sum over
// the staged window (column sums, then row sums in place), for the dy rows
// of warps 0-1 and then of warps 2-4, each followed by those warps'
// epilogue; S is a block reduction.  The epilogue writes S + E - 2C for dy,
// dx < 2R + 1 only: the padded rows and columns of the tiles are computed
// and dropped.  The first-minimum argmin stays outside, in
// motion.full_search_slab / full_search_multi.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ssd_tc_core.cuh"

namespace {

using namespace hevc_tc;

constexpr int WARPS = MAX_MT;
constexpr int THREADS = 32 * WARPS;
// E in two parts: the dy rows of warps 0-1, then of warps 2-4.
constexpr int H_BYTES = (E_HALF * E_STRIDE * 4 + 127) / 128 * 128;   // 17152
constexpr int SMEM = WIN_SMEM + Z_BYTES + H_BYTES + 4 * WARPS;
static_assert(CTU * CTU <= H_BYTES, "the source is staged in the E buffer");

__global__ void __launch_bounds__(THREADS, 4)
ssd_grid_plane_kernel(const uint8_t* __restrict__ src, const uint8_t* __restrict__ planes,
                      int32_t* __restrict__ out, int gc, long long plane_stride,
                      int row_stride, int k, int radius) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* s_win = smem;
  uint2* s_z = reinterpret_cast<uint2*>(smem + WIN_SMEM);
  int32_t* s_h = reinterpret_cast<int32_t*>(smem + WIN_SMEM + Z_BYTES);
  int32_t* s_red = reinterpret_cast<int32_t*>(smem + WIN_SMEM + Z_BYTES + H_BYTES);

  const int num = 2 * radius + 1;
  const int wide = CTU + 2 * radius;
  const int mt_count = (num + 15) / 16, nt_count = (num + 7) / 8;
  const int ks_count = (wide + 31) / 32;
  const int ctu = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5;
  const size_t row0 = static_cast<size_t>(ctu / gc) * CTU;
  const size_t col0 = static_cast<size_t>(ctu % gc) * CTU;

  // The CTU, once for all planes: its words (in the E buffer), Z and S.
  const int s_total = stage_source<THREADS>(src + static_cast<size_t>(ctu) * CTU * CTU,
                                            reinterpret_cast<uint32_t*>(s_h), s_z, s_red);

  for (int p = 0; p < k; ++p) {
    // Every thread is done with the previous plane's window and E.
    __syncthreads();
    stage_window<THREADS>(planes + p * plane_stride + row0 * row_stride + col0, row_stride,
                          wide, s_win);
    __syncthreads();

    int acc[MAX_NT][4];
    if (warp < mt_count) tc_products(acc, s_win, s_z, warp, ks_count, nt_count);

    // E and the epilogue for warps 0-1 (dy rows 0..31), then for warps 2-4
    // (dy rows 32..2R), so that E needs at most 33 rows of shared memory.
    int32_t* o = out + (static_cast<size_t>(ctu) * k + p) * num * num;
    for (int part = 0; part < 2; ++part) {
      const int d0 = 32 * part, rows = min(part ? E_HALF : 32, num - d0);
      if (rows <= 0) break;
      __syncthreads();   // the products, or the first part's epilogue, are done
      window_energy(s_win, s_h, d0, rows, wide, num, tid, THREADS, BlockSync());
      __syncthreads();
      if (warp < mt_count && (warp >= 2) == (part == 1))
        for_each_candidate(acc, warp, num, [&](int dy, int dx, int c) {
          o[dy * num + dx] = s_total + s_h[(dy - d0) * E_STRIDE + dx] - 2 * c;
        });
    }
  }
}

cudaError_t use_device(int device) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  return err;
}

cudaError_t launch(const uint8_t* src, const uint8_t* planes, int32_t* out, int n,
                   int k, int gc, long long plane_stride, int row_stride, int radius,
                   int device, cudaStream_t stream) {
  if (radius < 1 || radius > MAX_R || gc < 1 || k < 1 || n < 0) return cudaErrorInvalidValue;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  if (n == 0) return cudaGetLastError();
  err = cudaFuncSetAttribute(ssd_grid_plane_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return err;
  ssd_grid_plane_kernel<<<n, THREADS, SMEM, stream>>>(src, planes, out, gc, plane_stride,
                                                      row_stride, k, radius);
  return cudaGetLastError();
}

}  // namespace

// K1.  src (n, 64, 64) uint8; plane (plane_h, plane_w) uint8, contiguous,
// with plane_h >= 64 * (n / gc) + 2R and plane_w >= 64 * gc + 2R (the
// caller checks); out (n, 2R+1, 2R+1) int32.  Launches on `stream` and
// returns cudaGetLastError().
extern "C" int hevc_ssd_grid_plane(const uint8_t* src, const uint8_t* plane,
                                   int32_t* out, int n, int gc, int plane_h,
                                   int plane_w, int radius, int device,
                                   void* stream) {
  (void)plane_h;
  return launch(src, plane, out, n, 1, gc, 0, plane_w, radius, device,
                static_cast<cudaStream_t>(stream));
}

// B7.  src (n, 64, 64) uint8 contiguous; k planes, plane p at planes +
// p * plane_stride, rows row_stride bytes apart, each at least
// 64 * (n / gc) + 2R rows of 64 * gc + 2R bytes (the caller checks); out
// (n, k, 2R+1, 2R+1) int32.  Launches on `stream` and returns
// cudaGetLastError().
extern "C" int hevc_ssd_grid_plane_multi(const uint8_t* src, const uint8_t* planes,
                                         int32_t* out, int n, int k, int gc,
                                         long long plane_stride, int row_stride,
                                         int radius, int device, void* stream) {
  return launch(src, planes, out, n, k, gc, plane_stride, row_stride, radius, device,
                static_cast<cudaStream_t>(stream));
}
