// Kernel B9: the exact SAD grid of square blocks against given windows.
//
// Replaces hevcasm_tpu/kernels/sad_pallas.py sad_grid (body
// _sad_grid_kernel).  For block i of side B in {8, 16, 32, 64} and its
// window of at least (B + num_dy - 1) x (B + num_dx - 1) bytes:
//
//   out[i][dy][dx] = sum_{y,x < B} |win[i][dy + y][dx + x] - src[i][y][x]|
//
// in exact int32.  Every search under me_metric="sad" runs it: the full
// search on gathered CTU windows, both levels of the pyramid search, the PU
// decision's sub-block grids, and the multi-reference and B-frame searches.
//
// What bounds it on the H100: integer work on the CUDA cores.  |a - b| is
// not a product, so the int8 tensor cores cannot run it: 8.8 G terms for
// the 510 CTUs of a 1920x1088 frame at R = 32.  Memory traffic is small (a
// block and its window in, the grid out).
//
// Design: packed terms.  One vabsdiff4 with .add (VABSDIFF4 in the SASS)
// adds the absolute differences of four byte pairs to a sum, so a 4-byte
// source word against the 4 window bytes of one candidate is one
// instruction.  A candidate dx that is not a multiple of 4 needs its window
// bytes shifted; the block stages four copies of its window rows in shared
// memory, copy s shifted left by s bytes (word w of copy s is window bytes
// s + 4w .. s + 4w + 3), and each thread takes one residue class s and J
// consecutive candidates dx = s + 4j, j = j0 .. j0 + J - 1, of one dy row.
// For source word xw of row y, candidate j needs word j + xw of its copy's
// row dy + y: the J + B/4 words a row needs are one run of aligned 16-byte
// (or 8-byte) shared loads, and each of the B/4 x J terms is then one
// VABSDIFF4 on registers.  The source row, B/4 words, is a broadcast load
// shared by every thread, once per row: one thread a dy row keeps the
// loads below 10% of the instructions at B >= 16, so a thread does not hold
// several dy rows (their sums would cost registers and threads for little).
// J in {2, 4, 8} is chosen per call for the fewest instructions, idle
// candidates counted (num_dx = 65: J = 4, 17 groups covering 68 candidates;
// the pyramid's 7 and 17: J = 2 and 4).  About 18 instructions feed 64
// terms at B = 64.
// The staging reads each window word once or twice (L1) and writes the
// four copies in one pass, warps over rows and lanes over words.  A block
// holds a slice of dy rows, at most 256 threads (512 took 0.40 against
// 0.35 ms for 8160 16x16 blocks at R = 32 on an H100, 700 W) and 100 KB,
// and at least 4 warps, which the pyramid's fine level (28 busy threads a
// block) needs for its staging.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "ssd_tc_core.cuh"     // load_word

namespace {

using hevc_tc::load_word;

constexpr int MAX_THREADS = 256;
constexpr int MIN_THREADS = 128;           // a block stages its rows with at least 4 warps
constexpr size_t MAX_SMEM = 100 * 1024;
constexpr int CLASSES = 4;                 // dx residues mod 4: the window copies

// d = c + sum over the 4 bytes of |a_b - b_b|.
__device__ __forceinline__ uint32_t sad4_add(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("vabsdiff4.u32.u32.u32.add %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// Window bytes x .. x + 3 of a row `width` bytes wide, 0 past its end.
__device__ __forceinline__ uint32_t window_word(const uint8_t* row, int x, int width) {
  if (x + 4 <= width) return load_word(row + x);
  uint32_t v = 0;
  for (int k = 0; k < width - x; ++k) v |= static_cast<uint32_t>(row[x + k]) << (8 * k);
  return v;
}

// Words of residue class s: the candidates dx = s + 4j < num_dx.
__host__ __device__ inline int class_words(int num_dx, int s) {
  return num_dx > s ? (num_dx - s + 3) / 4 : 0;
}

__host__ __device__ inline int class_groups(int num_dx, int s, int j) {
  return (class_words(num_dx, s) + j - 1) / j;
}

template <int N, typename V>
__device__ __forceinline__ void load_run(uint32_t (&dst)[N], const uint32_t* p) {
  constexpr int VW = sizeof(V) / 4;
  static_assert(N % VW == 0, "run length");
#pragma unroll
  for (int v = 0; v < N / VW; ++v) {
    const V x = reinterpret_cast<const V*>(p)[v];
    const uint32_t* e = reinterpret_cast<const uint32_t*>(&x);
#pragma unroll
    for (int u = 0; u < VW; ++u) dst[VW * v + u] = e[u];
  }
}

// Block (i, slice): dy rows [slice * dy_per_block, ...) of block i.  Shared
// memory: the source (B rows of B/4 words), then CLASSES copies of the
// slice's window rows, each (dy_per_block + B - 1) rows of cs words.
template <int B, int J>
__global__ void __launch_bounds__(MAX_THREADS)
sad_grid_kernel(const uint8_t* __restrict__ src, const uint8_t* __restrict__ windows,
                int win_stride, int row_stride, int win_h, int win_w, int num_dy, int num_dx,
                int dy_per_block, int cs, int32_t* __restrict__ out) {
  constexpr int SW = B / 4;                             // source words a row
  constexpr int SEG = J + SW;                           // window words a row (one spare)
  constexpr int SVEC = SW % 4 == 0 ? 4 : 2;
  constexpr int WVEC = (J % 4 == 0 && SW % 4 == 0) ? 4 : 2;
  using SV = typename std::conditional<SVEC == 4, uint4, uint2>::type;
  using WV = typename std::conditional<WVEC == 4, uint4, uint2>::type;
  extern __shared__ __align__(16) uint32_t s_words[];
  uint32_t* s_src = s_words;
  uint32_t* s_win = s_words + B * SW;
  const int copy = (dy_per_block + B - 1) * cs;

  const int blk = blockIdx.x;
  const int dy0 = blockIdx.y * dy_per_block;
  const int rows = min(dy_per_block, num_dy - dy0);
  const int wrows = rows + B - 1;
  const int t = threadIdx.x, nt = blockDim.x;

  const uint8_t* s = src + static_cast<size_t>(blk) * B * B;
  for (int i = t; i < B * SW; i += nt) s_src[i] = load_word(s + 4 * i);
  // The window rows: word x of copy c is window bytes c + 4x .. c + 4x + 3,
  // from the window's words x and x + 1; bytes past the window are 0 (they
  // reach only candidates past num_dx or num_dy, which are not written).
  // Warps take rows, lanes words.
  const uint8_t* w = windows + static_cast<size_t>(blk) * win_stride
                     + static_cast<size_t>(dy0) * row_stride;
  const int lane = t & 31;
  for (int r = t >> 5; r < wrows; r += nt >> 5) {
    const uint8_t* rp = w + static_cast<size_t>(r) * row_stride;
    const int width = dy0 + r < win_h ? win_w : 0;
    for (int x = lane; x < cs; x += 32) {
      const uint32_t lo = window_word(rp, 4 * x, width), hi = window_word(rp, 4 * x + 4, width);
      uint32_t* d = s_win + r * cs + x;
      d[0] = lo;
#pragma unroll
      for (int c = 1; c < CLASSES; ++c) d[c * copy] = __funnelshift_r(lo, hi, 8 * c);
    }
  }
  __syncthreads();

  // This thread: candidate group g of dy row dyl.  Groups run through
  // the classes in order, class_groups(num_dx, s, J) each.
  int groups = 0;
#pragma unroll
  for (int c = 0; c < CLASSES; ++c) groups += class_groups(num_dx, c, J);
  const int dyl = t / groups;
  if (dyl >= rows) return;
  int g = t - dyl * groups, cls = 0;
  while (g >= class_groups(num_dx, cls, J)) g -= class_groups(num_dx, cls++, J);
  const int j0 = g * J;
  const uint32_t* wrow = s_win + cls * copy + dyl * cs + j0;

  uint32_t acc[J];
#pragma unroll
  for (int j = 0; j < J; ++j) acc[j] = 0;
#pragma unroll 2
  for (int y = 0; y < B; ++y) {
    uint32_t sw[SW], ww[SEG];
    load_run<SW, SV>(sw, s_src + y * SW);
    load_run<SEG, WV>(ww, wrow + y * cs);
#pragma unroll
    for (int xw = 0; xw < SW; ++xw)
#pragma unroll
      for (int j = 0; j < J; ++j) acc[j] = sad4_add(ww[j + xw], sw[xw], acc[j]);
  }
  int32_t* o = out + (static_cast<size_t>(blk) * num_dy + dy0 + dyl) * num_dx;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int dx = cls + 4 * (j0 + j);
    if (dx < num_dx) o[dx] = static_cast<int32_t>(acc[j]);
  }
}

template <int B, int J>
cudaError_t launch(int n, const uint8_t* src, const uint8_t* windows, int win_stride,
                   int row_stride, int win_h, int win_w, int num_dy, int num_dx, int dy,
                   int slices, int threads, int cs, size_t smem, int32_t* out,
                   cudaStream_t stream) {
  auto kernel = sad_grid_kernel<B, J>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(n, slices), threads, smem, stream>>>(src, windows, win_stride, row_stride,
                                                     win_h, win_w, num_dy, num_dx, dy, cs, out);
  return cudaGetLastError();
}

// The plan of one call: J, the copies' row stride in words, the dy rows of
// a block.  J takes the fewest instructions a (dy row, source row): groups
// x (J * B/4 packed terms + the run's and the source row's loads).
struct Plan {
  int j, cs, dy, slices, threads;
  size_t smem;
};

bool plan(int b, int num_dy, int num_dx, Plan* p) {
  const int sw = b / 4;
  long best = -1;
  for (int j : {8, 4, 2}) {
    int groups = 0;
    for (int c = 0; c < CLASSES; ++c) groups += class_groups(num_dx, c, j);
    const long cost = static_cast<long>(groups) * (j * sw + (j + sw + 3) / 4 + (sw + 3) / 4);
    if (best < 0 || cost < best) {
      best = cost;
      p->j = j;
    }
  }
  int groups = 0;
  for (int c = 0; c < CLASSES; ++c) groups += class_groups(num_dx, c, p->j);
  if (groups > MAX_THREADS) return false;
  // A copy row holds every word a thread of class 0 reads, and one more for
  // the shifts; an odd number of 16-byte units spreads rows over the banks.
  p->cs = (class_groups(num_dx, 0, p->j) * p->j + sw + 1 + 3) / 4 * 4;
  if ((p->cs / 4) % 2 == 0) p->cs += 4;
  auto smem_of = [&](int rows) {
    return static_cast<size_t>(b * sw + CLASSES * (rows + b - 1) * p->cs) * 4;
  };
  int per = MAX_THREADS / groups;
  while (per > 1 && smem_of(per) > MAX_SMEM) --per;
  if (smem_of(per) > MAX_SMEM) return false;
  p->slices = (num_dy + per - 1) / per;
  p->dy = (num_dy + p->slices - 1) / p->slices;
  p->threads = std::max(MIN_THREADS, (groups * p->dy + 31) / 32 * 32);
  p->smem = smem_of(p->dy);
  return p->slices <= 65535;
}

}  // namespace

// src (n, B, B) uint8 contiguous; windows: block i's at windows + i *
// win_stride, rows row_stride bytes apart, win_h x win_w bytes with win_h
// >= B + num_dy - 1 and win_w >= B + num_dx - 1; out (n, num_dy, num_dx)
// int32.  Launches on `stream` and returns cudaGetLastError()
// (cudaErrorInvalidValue for a geometry it does not take).
extern "C" int hevc_sad_grid(const uint8_t* src, const uint8_t* windows, int win_stride,
                             int row_stride, int win_h, int win_w, int32_t* out, int n,
                             int b, int num_dy, int num_dx, int device, void* stream) {
  if (num_dy < 1 || num_dx < 1 || win_h < b + num_dy - 1 || win_w < b + num_dx - 1)
    return cudaErrorInvalidValue;
  if (b != 8 && b != 16 && b != 32 && b != 64) return cudaErrorInvalidValue;
  Plan p;
  if (!plan(b, num_dy, num_dx, &p)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n == 0) return cudaGetLastError();
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define HEVC_LAUNCH(B, J)                                                                \
  if (b == B && p.j == J)                                                                \
    return launch<B, J>(n, src, windows, win_stride, row_stride, win_h, win_w, num_dy,  \
                        num_dx, p.dy, p.slices, p.threads, p.cs, p.smem, out, s);
  HEVC_LAUNCH(8, 2) HEVC_LAUNCH(8, 4) HEVC_LAUNCH(8, 8)
  HEVC_LAUNCH(16, 2) HEVC_LAUNCH(16, 4) HEVC_LAUNCH(16, 8)
  HEVC_LAUNCH(32, 2) HEVC_LAUNCH(32, 4) HEVC_LAUNCH(32, 8)
  HEVC_LAUNCH(64, 2) HEVC_LAUNCH(64, 4) HEVC_LAUNCH(64, 8)
#undef HEVC_LAUNCH
  return cudaErrorInvalidValue;
}
