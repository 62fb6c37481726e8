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
// shift, loaded a row ahead (the tensor-core pieces, shared with B15, are
// csrc/ssd_tc_core.cuh).  The fragment of k step ks and n tile nt is
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
constexpr int WROWS = CTU + 2 * MAX_R;               // 128 window rows staged
// Column sums, then E in place, for 32 or 33 dy rows at a time (the dy rows
// of warps 0-1, then of warps 2-4): rows of 64 + 2R int32, 129 apart so that
// a warp reading one column of rows hits 32 banks.
constexpr int HS = CTU + 2 * MAX_R + 1;
constexpr int HROWS = MAX_NUM - 32;                            // 33
constexpr int W_BYTES = WROWS * WS;                            // 18432
constexpr int H_BYTES = (HROWS * HS * 4 + 127) / 128 * 128;    // 17152
constexpr int SMEM = W_BYTES + Z_BYTES + H_BYTES + 4 * WARPS;
constexpr int STAGE = 8;                 // window words a thread loads at once
// The m16 tiles read window rows up to 63 + 16 MT - 1; the rows past the
// window (at most 15 at R = 32) land in s_z and only feed dy >= 2R + 1.
static_assert((CTU - 1 + 16 * MAX_MT) * WS <= W_BYTES + Z_BYTES, "tile rows past smem");
static_assert(CTU * CTU <= H_BYTES, "the source is staged in the E buffer");
static_assert(W_BYTES % 16 == 0, "window rows");

__global__ void __launch_bounds__(THREADS, 4)
ssd_grid_plane_kernel(const uint8_t* __restrict__ src, const uint8_t* __restrict__ planes,
                      int32_t* __restrict__ out, int gc, long long plane_stride,
                      int row_stride, int k, int radius) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* s_win = smem;
  uint2* s_z = reinterpret_cast<uint2*>(smem + W_BYTES);
  int32_t* s_h = reinterpret_cast<int32_t*>(smem + W_BYTES + Z_BYTES);
  int32_t* s_red = reinterpret_cast<int32_t*>(smem + W_BYTES + Z_BYTES + H_BYTES);

  const int num = 2 * radius + 1;
  const int wide = CTU + 2 * radius;
  const int mt_count = (num + 15) / 16, nt_count = (num + 7) / 8;
  const int ks_count = (wide + 31) / 32;
  const int ctu = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t row0 = static_cast<size_t>(ctu / gc) * CTU;
  const size_t col0 = static_cast<size_t>(ctu % gc) * CTU;

  // The CTU, once for all planes: its words into the E buffer, and S.
  {
    const uint8_t* s = src + static_cast<size_t>(ctu) * CTU * CTU;
    uint32_t* staged = reinterpret_cast<uint32_t*>(s_h);
    uint32_t v[(CTU * CTU / 4 + THREADS - 1) / THREADS];
#pragma unroll
    for (int u = 0; u < (CTU * CTU / 4 + THREADS - 1) / THREADS; ++u) {
      const int i = tid + u * THREADS;
      v[u] = i < CTU * CTU / 4 ? load_word(s + 4 * i) : 0u;
    }
    int sq = 0;
#pragma unroll
    for (int u = 0; u < (CTU * CTU / 4 + THREADS - 1) / THREADS; ++u) {
      const int i = tid + u * THREADS;
      if (i < CTU * CTU / 4) staged[i] = v[u];
      sq += sq_bytes(v[u]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sq += __shfl_down_sync(0xffffffffu, sq, off);
    if (lane == 0) s_red[warp] = sq;
    __syncthreads();
    stage_z(staged, s_z);
  }
  int s_total = 0;
#pragma unroll
  for (int i = 0; i < WARPS; ++i) s_total += s_red[i];

  // This lane's part of the B fragments: word i of B_y's 10 non-zero words
  // (j - dx = d = -8 + 8i), from the pair s_z[y][zq + 2i] (ssd_tc_core.cuh).
  const int g = lane >> 2, t = lane & 3;
  const BandLane bl = band_lane(lane);
  const int zq = bl.zq;
  const unsigned zsh = bl.zsh;
  const int dy0 = 16 * warp;
  const uint8_t* a_lane = s_win + (dy0 + (lane & 15)) * WS + 16 * (lane >> 4);

  for (int p = 0; p < k; ++p) {
    // Every thread is done with the previous plane's window and E.
    __syncthreads();
    // The window's rows, STAGE words a thread in flight; bytes past its
    // width are 0.
    const uint8_t* base = planes + p * plane_stride + row0 * row_stride + col0;
    const int words = wide * (WS / 4);
    for (int i0 = tid; i0 < words; i0 += STAGE * THREADS) {
      uint32_t v[STAGE];
#pragma unroll
      for (int u = 0; u < STAGE; ++u) {
        const int i = i0 + u * THREADS;
        const int y = i / (WS / 4), x = 4 * (i - y * (WS / 4));
        v[u] = 0;
        if (i < words && x < wide) {
          const uint8_t* rp = base + static_cast<size_t>(y) * row_stride + x;
          v[u] = x + 4 <= wide ? load_word(rp)
                               : (rp[0] | (static_cast<uint32_t>(rp[1]) << 8));
        }
      }
#pragma unroll
      for (int u = 0; u < STAGE; ++u) {
        const int i = i0 + u * THREADS;
        if (i < words) reinterpret_cast<uint32_t*>(s_win)[i] = v[u];
      }
    }
    __syncthreads();

    // C on the tensor cores; source row y + 1's B words are loaded while
    // row y's products run, and two rows are unrolled (faster on an H100
    // than one; issuing the k steps out of order was slower).
    int acc[MAX_NT][4];
#pragma unroll
    for (int nt = 0; nt < MAX_NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[nt][i] = 0;
    if (warp < mt_count) {
      uint2 zn[BAND_WORDS];
#pragma unroll
      for (int i = 0; i < BAND_WORDS; ++i) zn[i] = s_z[zq + 2 * i];
#pragma unroll 2
      for (int y = 0; y < CTU; ++y) {
        uint32_t wd[BAND_WORDS];
#pragma unroll
        for (int i = 0; i < BAND_WORDS; ++i) wd[i] = band_word(zn[i], zsh);
        if (y + 1 < CTU) {
          const uint2* zr = s_z + (y + 1) * ZW + zq;
#pragma unroll
          for (int i = 0; i < BAND_WORDS; ++i) zn[i] = zr[2 * i];
        }
        const uint8_t* ar = a_lane + y * WS;
#pragma unroll
        for (int ks = 0; ks < MAX_KS; ++ks) {
          if (ks >= ks_count) break;
          uint32_t a[4];
          ldmatrix_x4(a, ar + 32 * ks);
#pragma unroll
          for (int nt = 0; nt < MAX_NT; ++nt) {
            const int d = 32 * ks - 8 * nt;   // j - dx at the tile's corner
            if (d < -24 || d > 64) continue;
            if (nt >= nt_count) break;
            const uint32_t b0 = d >= -8 ? wd[(d + 8) / 8] : 0u;
            const uint32_t b1 = d + 16 <= 64 ? wd[(d + 24) / 8] : 0u;
            mma_u8(acc[nt], a, b0, b1);
          }
        }
      }
    }

    // E and the epilogue for warps 0-1 (dy rows 0..31), then for warps 2-4
    // (dy rows 32..2R), so that E needs at most 33 rows of shared memory.
    int32_t* o = out + (static_cast<size_t>(ctu) * k + p) * num * num;
    for (int part = 0; part < 2; ++part) {
      const int d0 = 32 * part, rows = min(part ? HROWS : 32, num - d0);
      if (rows <= 0) break;
      __syncthreads();   // the MMA loop, or the first part's epilogue, is done
      // Column sums of squares over 64 rows, sliding down dy ...
      if (tid < wide) {
        int cs = 0;
#pragma unroll 16
        for (int y = 0; y < CTU; ++y) {
          const int v = s_win[(d0 + y) * WS + tid];
          cs += v * v;
        }
        s_h[tid] = cs;
#pragma unroll 4
        for (int r = 1; r < rows; ++r) {
          const int a = s_win[(d0 + r + CTU - 1) * WS + tid], b = s_win[(d0 + r - 1) * WS + tid];
          cs += a * a - b * b;
          s_h[r * HS + tid] = cs;
        }
      }
      __syncthreads();
      // ... then sums of 64 of them, sliding across dx, in place.
      if (tid < rows) {
        int32_t* row = s_h + tid * HS;
        int e = 0;
#pragma unroll 16
        for (int x = 0; x < CTU; ++x) e += row[x];
#pragma unroll 4
        for (int dx = 0; dx < num; ++dx) {
          const int old = row[dx];
          row[dx] = e;
          if (dx + 1 < num) e += row[dx + CTU] - old;
        }
      }
      __syncthreads();
      if (warp < mt_count && (warp >= 2) == (part == 1)) {
#pragma unroll
        for (int nt = 0; nt < MAX_NT; ++nt) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int dy = dy0 + g + 8 * (i >> 1), dx = 8 * nt + 2 * t + (i & 1);
            if (dy < num && dx < num)
              o[dy * num + dx] = s_total + s_h[(dy - d0) * HS + dx] - 2 * acc[nt][i];
          }
        }
      }
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
