// Kernel B8: the exact SSD grid of square blocks against given windows.
//
// Replaces hevcasm_tpu/kernels/search_pallas.py ssd_grid (bodies _kernel,
// _kernel_chunked and _kernel_corr).  For block i of side B in
// {8, 16, 32, 64} and its window of at least (B + num_dy - 1) x
// (B + num_dx - 1) bytes (at most 256 x 256 read):
//
//   out[i][dy][dx] = sum_{y,x < B} (win[i][dy + y][dx + x] - src[i][y][x])^2
//                  = S + E[dy][dx] - 2 C[dy][dx]
//   S = sum s^2,  E[dy][dx] = sum_{y,x < B} win[dy + y][dx + x]^2,
//   C[dy][dx] = sum_{y < B} sum_j A_y[dy][j] B_y[j][dx],
//   A_y[dy][j] = win[y + dy][j],  B_y[j][dx] = s[y][j - dx] (0 outside 0..B-1)
//
// in exact int32 (a 64 x 64 sum is below 4096 * 255^2 < 2^31, and S + E
// too).  The PU decision runs it on the (B + 2R)^2 sub-block windows of
// encode/partition.base_grid_search wherever B14/B15 do not serve (R !=
// 32), the pyramid search on its two levels, and the full search on
// gathered CTU windows where K1 does not (search_impl="grid").
//
// What bounds it on the H100: the grids it writes and the windows it reads
// (56 MB for the 8160 16 x 16 blocks of a 1920x1088 frame at R = 16: 0.0168
// ms at 3.35 TB/s); its B^2 num_dy num_dx multiply-adds take a seventh of
// that on the int8 tensor cores.
//
// Design: C on mma.sync m16n8k32 u8 x u8 -> s32 with K1's fragments
// (csrc/ssd_tc_core.cuh narrow_products): A_y is the staged window read in
// place by ldmatrix at row offset y, in m16 tiles of dy; B_y, the Toeplitz
// band of source row y, B bytes wide, comes from the lane's B / 8 + 2 band
// words of Z_y (s[y] at byte 16 of a zero-padded row of B / 4 + 8 word
// pairs); the k32 steps run over window columns, and a (k step, n tile)
// fragment is skipped unless its band meets the source's B columns, 32 ks -
// 8 nt in [-24, B].  A warp owns one m tile of one source block and up to
// 9 n tiles (36 accumulators).
//
// A thread block holds SB source blocks (a few thousand blocks for the
// 8160 or 32640 of a frame, not one per block), MB m tiles of each (one
// warp each) and one n range of up to 9 n tiles; windows taller than 8 m
// tiles or wider than 9 n tiles are tiled over blocks (grid y and z), and
// each block stages only the window rows and columns its tiles read, rows
// WS apart (32 KS + 16 bytes: ldmatrix's eight row reads hit eight bank
// groups).  Per source block it builds Z and S, and E by separable running
// sums (column sums of B rows of w^2 sliding down dy, a thread a column;
// then sums of B of them sliding across dx in place, a thread a row: for
// rows this short a serial pass was faster on an H100 than a warp's prefix
// scan); each warp adds S - 2C at its candidates (dy, dx < num: the tiles'
// padded rows and columns are dropped) and the block writes its rows, a
// warp a row, 4-byte stores contiguous across the warp.  SB aims at 8 warps
// a block and at most 96 KB of shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ssd_tc_core.cuh"

namespace {

using hevc_tc::BandLane;
using hevc_tc::MAX_NT;

constexpr int MAX_MB = 8;                  // m16 tiles of dy a source block in a block
constexpr int TARGET_WARPS = 8;
constexpr int SMEM_CAP = 96 * 1024;
constexpr int MAX_WINDOW = 256;
constexpr int ZOFF = 16;                   // s[y][0] at byte ZOFF of Z_y
static_assert(MAX_MB <= TARGET_WARPS, "a block has at most TARGET_WARPS warps");

template <int B>
struct Narrow {
  static constexpr int ZP = B / 4 + 8;                     // Z word pairs a row
  static constexpr int KS = (8 * MAX_NT + B - 1 + 31) / 32;  // k32 steps of a block's columns
  static constexpr int WS = 32 * KS + 16;                  // staged window row stride
  static constexpr int ROW_WORDS = 8 * KS;                 // window words staged a row
  static_assert(WS % 16 == 0 && WS % 128 != 0, "window row stride");
  static_assert(8 * MAX_NT <= 96, "a row of the block's grid is three warp stores");
};

__host__ __device__ constexpr int round16(int v) { return (v + 15) / 16 * 16; }

// A launch's geometry, from the host.
struct Plan {
  int sb, mb, ntb;            // source blocks, m tiles and n tiles a block
  int rows, es;               // staged window rows and E's row stride
  int win, z, e, per;         // bytes a source block: window, Z, E (first its words), all
  int smem;
};

template <int B>
Plan make_plan(int n, int num_dy, int num_dx) {
  using N = Narrow<B>;
  Plan p;
  const int mt = (num_dy + 15) / 16, nt = (num_dx + 7) / 8;
  const int m_groups = (mt + MAX_MB - 1) / MAX_MB;
  p.mb = (mt + m_groups - 1) / m_groups;
  const int n_groups = (nt + MAX_NT - 1) / MAX_NT;
  p.ntb = (nt + n_groups - 1) / n_groups;
  p.rows = 16 * p.mb + B - 1;
  const int wcols = (8 * p.ntb < num_dx ? 8 * p.ntb : num_dx) + B - 1;
  p.es = wcols | 1;
  const int rows_e = 16 * p.mb < num_dy ? 16 * p.mb : num_dy;
  p.win = p.rows * N::WS;
  p.z = B * N::ZP * 8;
  p.e = round16(rows_e * p.es * 4 > B * B ? rows_e * p.es * 4 : B * B);
  p.per = p.win + p.z + p.e;
  int sb = TARGET_WARPS / p.mb > 1 ? TARGET_WARPS / p.mb : 1;
  if (sb * p.per > SMEM_CAP) sb = SMEM_CAP / p.per > 1 ? SMEM_CAP / p.per : 1;
  p.sb = sb < n ? sb : n;
  p.smem = p.sb * p.per + round16(4 * p.sb);
  return p;
}

// Block (source blocks SB x, m group y, n group z).  Shared memory: for
// each of its SB source blocks the window rows (plan.rows of WS bytes), Z
// (B rows of ZP pairs) and E (rows of plan.es int32: first the source
// block's words, then the column sums, then E, then the grid); then S of
// each.
template <int B>
__global__ void __launch_bounds__(32 * TARGET_WARPS)
ssd_grid_tc_kernel(const uint8_t* __restrict__ src, const uint8_t* __restrict__ windows,
                   int win_stride, int row_stride, int32_t* __restrict__ out, int n,
                   int num_dy, int num_dx, Plan plan) {
  using N = Narrow<B>;
  constexpr int SRC_WORDS = B * B / 4;
  constexpr int U = 4;                                       // window words a thread loads at once
  extern __shared__ __align__(128) uint8_t smem[];
  int32_t* s_sum = reinterpret_cast<int32_t*>(smem + plan.sb * plan.per);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nth = blockDim.x, warps = nth >> 5;
  const int blk0 = blockIdx.x * plan.sb;
  const int dy0 = 16 * plan.mb * blockIdx.y, dx0 = 8 * plan.ntb * blockIdx.z;
  const int rows_valid = min(16 * plan.mb, num_dy - dy0);
  const int cols = min(8 * plan.ntb, num_dx - dx0);          // candidate columns
  const int wrows = rows_valid + B - 1, wcols = cols + B - 1;  // window rows and columns read
  const int ks_count = (wcols + 31) / 32, nt_count = (cols + 7) / 8;
  auto win_of = [&](int slot) { return smem + slot * plan.per; };
  auto z_of = [&](int slot) {
    return reinterpret_cast<uint2*>(smem + slot * plan.per + plan.win);
  };
  auto e_of = [&](int slot) {
    return reinterpret_cast<int32_t*>(smem + slot * plan.per + plan.win + plan.z);
  };

  // The source blocks' words (into E's memory) and the window rows the
  // tiles read, ROW_WORDS words a row; bytes past the rows and columns read
  // are 0 (they feed only dy >= num_dy or dx >= num_dx).
  for (int slot = 0; slot < plan.sb; ++slot) {
    const int i = blk0 + slot;
    uint32_t* staged = reinterpret_cast<uint32_t*>(e_of(slot));
    const uint8_t* s = src + static_cast<size_t>(i) * B * B;
    for (int k = tid; k < SRC_WORDS; k += nth)
      staged[k] = i < n ? hevc_tc::load_word(s + 4 * k) : 0u;
    const uint8_t* w = windows + static_cast<size_t>(i) * win_stride
                       + static_cast<size_t>(dy0) * row_stride + dx0;
    uint32_t* sw = reinterpret_cast<uint32_t*>(win_of(slot));
    for (int k0 = tid; k0 < plan.rows * N::ROW_WORDS; k0 += U * nth) {
      uint32_t v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int k = k0 + u * nth;
        const int r = k / N::ROW_WORDS, x = 4 * (k - r * N::ROW_WORDS);
        v[u] = 0;
        if (i < n && r < wrows && x < wcols) {
          const uint8_t* rp = w + static_cast<size_t>(r) * row_stride + x;
          if (x + 4 <= wcols) {
            v[u] = hevc_tc::load_word(rp);
          } else {
            for (int b = 0; b < wcols - x; ++b) v[u] |= static_cast<uint32_t>(rp[b]) << (8 * b);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int k = k0 + u * nth;
        if (k < plan.rows * N::ROW_WORDS) {
          const int r = k / N::ROW_WORDS, x = k - r * N::ROW_WORDS;
          sw[r * (N::WS / 4) + x] = v[u];
        }
      }
    }
  }
  __syncthreads();
  // Z from the staged words: Z_y word q is source word q - ZOFF / 4 of row
  // y, 0 outside the row; and S, a warp a source block.
  for (int k = tid; k < plan.sb * B * N::ZP; k += nth) {
    const int slot = k / (B * N::ZP), j = k - slot * (B * N::ZP);
    const int y = j / N::ZP, q = j - y * N::ZP - ZOFF / 4;
    const uint32_t* row = reinterpret_cast<const uint32_t*>(e_of(slot)) + y * (B / 4);
    const uint32_t lo = (q >= 0 && q < B / 4) ? row[q] : 0u;
    const uint32_t hi = (q + 1 >= 0 && q + 1 < B / 4) ? row[q + 1] : 0u;
    z_of(slot)[j] = make_uint2(lo, hi);
  }
  for (int slot = warp; slot < plan.sb; slot += warps) {
    const uint32_t* staged = reinterpret_cast<const uint32_t*>(e_of(slot));
    int sq = 0;
    for (int k = lane; k < SRC_WORDS; k += 32) sq += hevc_tc::sq_bytes(staged[k]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, off);
    if (lane == 0) s_sum[slot] = sq;
  }
  __syncthreads();

  // The products, warp (slot, m); then E's column sums by all threads as
  // they finish (E's memory is free once Z and S are built), a thread a
  // column: cs[r][c] = sum_{y < B} w[r + y][c]^2 sliding down r.
  const int my_slot = warp / plan.mb, my_m = warp - my_slot * plan.mb;
  int acc[MAX_NT][4];
  const bool busy = 16 * my_m < rows_valid;
  if (busy) {
    const BandLane bl = hevc_tc::band_lane<ZOFF>(lane);
    const uint32_t all[B / 8 + 2] = {};
    hevc_tc::narrow_products<B, B, N::KS, N::WS, N::ZP, false>(
        acc, win_of(my_slot) + (16 * my_m + (lane & 15)) * N::WS + 16 * (lane >> 4),
        z_of(my_slot) + bl.zq, bl.zsh, all, ks_count, nt_count);
  }
  for (int k = tid; k < plan.sb * wcols; k += nth) {
    const int slot = k / wcols, c = k - slot * wcols;
    const uint8_t* col = win_of(slot) + c;
    int32_t* e = e_of(slot) + c;
    int cs = 0;
#pragma unroll 8
    for (int y = 0; y < B; ++y) {
      const int v = col[y * N::WS];
      cs += v * v;
    }
    e[0] = cs;
    for (int r = 1; r < rows_valid; ++r) {
      const int a = col[(r + B - 1) * N::WS], b = col[(r - 1) * N::WS];
      cs += a * a - b * b;
      e[r * plan.es] = cs;
    }
  }
  __syncthreads();
  // E[r][dx] = sum_{x < B} cs[r][dx + x], sliding across dx in place, a
  // thread a row.
  for (int k = tid; k < plan.sb * rows_valid; k += nth) {
    const int slot = k / rows_valid, r = k - slot * rows_valid;
    int32_t* row = e_of(slot) + r * plan.es;
    int s = 0;
#pragma unroll 8
    for (int x = 0; x < B; ++x) s += row[x];
    for (int dx = 0; dx < cols; ++dx) {
      const int old = row[dx];
      row[dx] = s;
      if (dx + 1 < cols) s += row[dx + B] - old;
    }
  }
  __syncthreads();
  // S + E - 2C at the warp's candidates: accumulator i of n tile nt holds
  // dy = 16 m + g + 8 (i >> 1), dx = 8 nt + 2t + (i & 1); the tiles' padded
  // rows and columns are dropped.
  if (busy) {
    const int g = lane >> 2, t = lane & 3;
    int32_t* e = e_of(my_slot);
    const int s_total = s_sum[my_slot];
#pragma unroll
    for (int nt = 0; nt < MAX_NT; ++nt)
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int dy = 16 * my_m + g + 8 * (a >> 1), dx = 8 * nt + 2 * t + (a & 1);
        if (dy < rows_valid && dx < cols) e[dy * plan.es + dx] += s_total - 2 * acc[nt][a];
      }
  }
  __syncthreads();
  // The block's grid rows, a warp a row, 4-byte stores contiguous across it.
  for (int k = warp; k < plan.sb * rows_valid; k += warps) {
    const int slot = k / rows_valid, r = k - slot * rows_valid;
    const int i = blk0 + slot;
    if (i >= n) break;
    const int32_t* row = e_of(slot) + r * plan.es;
    int32_t* o = out + (static_cast<size_t>(i) * num_dy + dy0 + r) * num_dx + dx0;
#pragma unroll
    for (int k3 = 0; k3 < 3; ++k3)
      if (lane + 32 * k3 < cols) o[lane + 32 * k3] = row[lane + 32 * k3];
  }
}

template <int B>
cudaError_t launch(int n, const uint8_t* src, const uint8_t* windows, int win_stride,
                   int row_stride, int num_dy, int num_dx, int32_t* out, cudaStream_t stream) {
  const Plan plan = make_plan<B>(n, num_dy, num_dx);
  if (plan.smem > 227 * 1024) return cudaErrorInvalidValue;
  const int m_groups = (num_dy + 16 * plan.mb - 1) / (16 * plan.mb);
  const int n_groups = ((num_dx + 7) / 8 + plan.ntb - 1) / plan.ntb;
  const unsigned blocks = static_cast<unsigned>((n + plan.sb - 1) / plan.sb);
  auto kernel = ssd_grid_tc_kernel<B>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         plan.smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(blocks, m_groups, n_groups), 32 * plan.sb * plan.mb, plan.smem, stream>>>(
      src, windows, win_stride, row_stride, out, n, num_dy, num_dx, plan);
  return cudaGetLastError();
}

}  // namespace

// src (n, B, B) uint8 contiguous; windows: block i's at windows + i *
// win_stride, rows row_stride bytes apart, win_h x win_w bytes with win_h
// >= B + num_dy - 1 and win_w >= B + num_dx - 1, of which at most 256 rows
// and columns are read; out (n, num_dy, num_dx) int32.  Launches on
// `stream` and returns cudaGetLastError() (cudaErrorInvalidValue for a
// geometry it does not take).
extern "C" int hevc_ssd_grid(const uint8_t* src, const uint8_t* windows, int win_stride,
                             int row_stride, int win_h, int win_w, int32_t* out, int n,
                             int b, int num_dy, int num_dx, int device, void* stream) {
  if (num_dy < 1 || num_dx < 1 || win_h < b + num_dy - 1 || win_w < b + num_dx - 1
      || b + num_dy - 1 > MAX_WINDOW || b + num_dx - 1 > MAX_WINDOW || n < 0)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n == 0) return cudaGetLastError();
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (b) {
    case 8: return launch<8>(n, src, windows, win_stride, row_stride, num_dy, num_dx, out, s);
    case 16: return launch<16>(n, src, windows, win_stride, row_stride, num_dy, num_dx, out, s);
    case 32: return launch<32>(n, src, windows, win_stride, row_stride, num_dy, num_dx, out, s);
    case 64: return launch<64>(n, src, windows, win_stride, row_stride, num_dy, num_dx, out, s);
    default: return cudaErrorInvalidValue;
  }
}
