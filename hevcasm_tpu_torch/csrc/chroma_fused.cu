// Kernels chroma_p_fused, chroma_b_fused and chroma_pu_fused: the chroma of
// a 4:2:0 P frame (one reference) or B frame (two references), both planes,
// in one launch; chroma_pu_fused is the P frame's with an MV a PU tile.
//
// Replace no TPU kernel: hevcasm_tpu codes a frame's chroma in plain ops
// (encode/video.py _chroma_mc, then _chroma_residual, a plane at a time; a
// B frame predicts each plane from both references as int16 (acc >> 6)
// intermediates and takes their mean (p0 + p1 + 64) >> 7), which the port
// ran as some 140 (P) or 200 (B) small torch ops and launches a plane, with
// the 4x4 transforms as float64 matrix products.  These kernels compute the
// same integers.  For 32x32 chroma block i (the chroma of 64x64 luma CTU i,
// raster order) of each plane, one CTA of 8 warps, with nothing written to
// device memory between the steps:
//
//   1. stages, for each reference r, the 35x35 window at the block's
//      position plus (mv_r >> 3) - 1 straight from the (h, w) reference
//      plane, rows and columns past the plane clamped to its edge
//      (pad_frame's edge replication): by 16-byte cp.async (mc_tc.cuh
//      stage_window) where the window lies inside the plane, else sample by
//      sample; and the 32x32 source block, 16 bytes a thread;
//   2. predicts it at fraction mv & 7 on both axes with B5's 4-tap
//      tensor-core core (mc_tc.cuh strip_task: a warp a 16-column strip and
//      a 16-row step), or, for a B frame, on B6's bi path of that core: each
//      reference's window at its own fraction, clip((wrap16(acc0 >> 6) +
//      wrap16(acc1 >> 6) + 64) >> 7), which is pred_uni_16 of each and
//      their mean; the prediction into shared memory;
//   3. codes it with the residual stage K2, B3, B4 and B19 share
//      (residual_core.cuh residual_tile<4>: a warp a 16x16 tile, 4x4 DCT,
//      quantize, per-TU nnz, dequantize, inverse, add and clip, the four
//      passes on mma.sync), at the chroma quantizer the wrapper passes (the
//      B frame's chroma takes the P frame's: inter, 4x4 TUs);
//   4. writes the 32x32 reconstruction into the (h, w) output plane, 16
//      bytes a thread, and adds the block's nnz to the plane's count
//      (nnz[0] Cb, nnz[1] Cr) with one atomicAdd; the C entry zeroes the
//      two counts before the launch.
//
// The RD P frame (pu_decision) predicts each PU at its own MV, so its
// chroma takes an MV field: one MV a (32 / k)-square tile of each block, k
// = 8 (4x4 tiles, the chroma of 8x8 luma PU tiles), 4, 2 or 1.
// chroma_pu_fused's CTA body, code_block_pu, replaces steps 1-2 by a scalar
// 4-tap filter on the CUDA cores, each thread 4 rows of one column of one
// tile, its 7 window rows read from the plane through the read-only cache
// with the edges clamped (B5's tensor-core strip takes one fraction a
// 16-column strip), and shares steps 3 and 4.
//
// One CTA body, code_block<R> over R = 1 (P) or 2 (B) references, serves
// the other two kernels: its arrays of R entries are indexed by constants the
// compiler unrolls, so the P instance is the body it was alone.  Steps 2
// and 3 keep the stride-64 layout their cores were written for (B5's
// output rows w apart, residual_tile's rows B apart), so the cores serve
// these kernels unchanged: the prediction, source and reconstruction tiles
// are 32 rows of 64 bytes in shared memory, and step 4 moves the
// reconstruction to the plane in whole 16-byte rows pieces.
//
// What bounds them on the H100: a 1920x1088 frame's two 960x544 planes are
// 0.52 MB each, read once as the source and once from each reference and
// written once: 3.1 MB (P) or 4.2 MB (B), 0.0009 or 0.0013 ms at 3.35 TB/s
// (the windows' overlap reads a reference ~1.2 times, from L2), for 2 x 510
// blocks of 5 m16n8k32 products a 16-row step of MC (twice for B) and 16
// m16n8k16 a 16x16 tile of residual: neither bytes nor products.  A call is
// bound by its latency (the launch, the windows' trip into shared memory,
// three barriers and each warp's chain of products) and, on the frame's
// path, by the host: one launch, and nothing else, where the plain
// composition enqueued ~280 (P) or ~400 (B).  chroma_pu_fused at k = 8 also
// reads its MV field (0.26 MB): 3.4 MB, 0.0010 ms, for 11 multiply-adds a
// predicted sample (a task's 7 x 4 horizontal and 4 x 4 vertical for 4).

#include "mc_tc.cuh"
#include "residual_core.cuh"

// The C entries' packed argument block over R references
// (kernels/chroma_fused.py: 17 int64 for the P frame's R = 1, 20 for the B
// frame's R = 2).  Planes j = 0 (Cb) and 1 (Cr): cur[j], ref[r][j] and
// rec[j] are (h, w) uint8, contiguous and 16-byte aligned; mv[r] holds block
// i's (dy, dx) luma quarter-pel MV into reference r at mv[r] + 2i (int32);
// nnz int32[2].
template <int R>
struct ChromaFusedArgs {
  long long cur[2], ref[R][2], rec[2];
  long long mv[R], nnz, h, w;
  long long q[5];    // qscale, qshift, qoffset, dscale, dshift
  long long device, stream;
};
using ChromaArgs = ChromaFusedArgs<1>;
using ChromaBiArgs = ChromaFusedArgs<2>;

// The per-PU instance's block (18 int64): the P frame's, with one MV a
// (32 / k)-square tile of each block, k = 1, 2, 4 or 8: tile (ty, tx) of
// block i at mv + 2 (k^2 i + k ty + tx).
struct ChromaPuArgs {
  long long cur[2], ref[2], rec[2];
  long long mv, nnz, h, w, k;
  long long q[5];
  long long device, stream;
};

namespace {
namespace chroma {

constexpr int N = 32;                      // block side
constexpr int TAPS = 4;                    // the chroma filters' taps
constexpr int WIN = N + TAPS - 1;          // window side
constexpr int NTHREADS = 256;              // 8 warps: one a (plane, strip, step) or tile
constexpr int TILE = N * B;                // a plane's 32 rows, B bytes apart
constexpr int COUNTS = 128;                // a plane's per-TU counts (TU grid rows B / 4 apart)

// One staged window, as mctc::geometry(N, N, 1) lays it out: rows WS bytes
// apart, 16 (N / 16 + 1) rows.
constexpr int WS = 16 * ((N / 16 + 2) | 1);
constexpr int WIN_BYTES = 16 * (N / 16 + 1) * WS;

// Shared memory of a CTA over R references: 2R windows (plane p's from
// reference r at R p + r), then the prediction, source and reconstruction
// tiles of both planes, then both planes' counts: 21,504 bytes (P) or
// 28,672 (B), static, so two CTAs share an SM.
template <int R>
constexpr int SMEM = 2 * R * WIN_BYTES + 3 * 2 * TILE + 2 * COUNTS * 4;
// The per-PU instance reads its windows from the planes: 13,312 bytes.
constexpr int SMEM_PU = 3 * 2 * TILE + 2 * COUNTS * 4;

struct alignas(16) Bytes16 {
  uint32_t w[4];
};

// Step 1 for a window that reaches past the plane: byte c of row r is the
// plane's sample at (y0 + r, x0 + c), each coordinate clamped to the plane,
// at win + r * WS + c.
__device__ __forceinline__ void stage_clamped(const uint8_t* __restrict__ plane, int h, int w,
                                              int y0, int x0, int nthreads, uint8_t* win) {
  for (int k = threadIdx.x; k < WIN * WIN; k += nthreads) {
    const int r = k / WIN, c = k - r * WIN;
    win[r * WS + c] = plane[static_cast<size_t>(clip3(0, h - 1, y0 + r)) * w +
                            clip3(0, w - 1, x0 + c)];
  }
}

// Step 1's source blocks: block (by, bx) of both planes into the source
// tiles, 16 bytes a thread.
__device__ __forceinline__ void stage_source(const long long (&cur)[2], int w, int by, int bx,
                                             int nthreads, uint8_t* src) {
  for (int k = threadIdx.x; k < 2 * N * N / 16; k += nthreads) {
    const int p = k / (N * N / 16), r = (k >> 1) % N, c = 16 * (k & 1);
    *reinterpret_cast<Bytes16*>(src + p * TILE + r * B + c) =
        *reinterpret_cast<const Bytes16*>(reinterpret_cast<const uint8_t*>(cur[p]) +
                                          static_cast<size_t>(N * by + r) * w + N * bx + c);
  }
}

// Steps 3 and 4, once the prediction tiles are written and the CTA has met.
__device__ __forceinline__ void code_and_store(const long long (&q)[5], const long long (&rec)[2],
                                               long long nnz, int w, int by, int bx,
                                               int nthreads, const uint8_t* src,
                                               const uint8_t* pred, uint8_t* out,
                                               int32_t* counts) {
  // ---- 3. the residual: task k is plane k >> 2, 16x16 tile ((k >> 1) & 1, k & 1)
  const QParams qp = {static_cast<int>(q[0]), static_cast<int>(q[1]), static_cast<int>(q[2]),
                      static_cast<int>(q[3]), static_cast<int>(q[4])};
  for (int k = threadIdx.x >> 5; k < 8; k += nthreads >> 5) {
    const int p = k >> 2;
    residual_tile<4>(src + p * TILE, pred + p * TILE, out + p * TILE, counts + p * COUNTS,
                     nullptr, (k >> 1) & 1, k & 1, qp);
  }
  __syncthreads();

  // ---- 4. the reconstruction to the planes, and the counts ------------------
  for (int k = threadIdx.x; k < 2 * N * N / 16; k += nthreads) {
    const int p = k / (N * N / 16), r = (k >> 1) % N, c = 16 * (k & 1);
    *reinterpret_cast<Bytes16*>(reinterpret_cast<uint8_t*>(rec[p]) +
                                static_cast<size_t>(N * by + r) * w + N * bx + c) =
        *reinterpret_cast<const Bytes16*>(out + p * TILE + r * B + c);
  }
  // The block's 8x8 TUs are entries (r, c < 8) of the TU grid residual_tile
  // fills (rows B / 4 apart): lane l sums row l >> 2, columns 2 (l & 3), + 1.
  for (int p = threadIdx.x >> 5; p < 2; p += nthreads >> 5) {
    const int lane = threadIdx.x & 31;
    const int32_t* row = counts + p * COUNTS + (lane >> 2) * (B / 4) + 2 * (lane & 3);
    int v = row[0] + row[1];
#pragma unroll
    for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0 && v) atomicAdd(reinterpret_cast<int*>(nnz) + p, v);
  }
}

// Block i of both planes, predicted from R references, by a CTA of nthreads
// threads (a multiple of 32); smem holds SMEM<R> bytes, 16-byte aligned.
template <int R>
__device__ __forceinline__ void code_block(const ChromaFusedArgs<R>& a, long long i,
                                           int nthreads, uint8_t* smem) {
  const int h = static_cast<int>(a.h), w = static_cast<int>(a.w), gc = w / N;
  const int by = static_cast<int>(i / gc), bx = static_cast<int>(i - static_cast<long long>(by) * gc);
  int my[R], mx[R], y0[R], x0[R];
  bool inside[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int32_t* mv = reinterpret_cast<const int32_t*>(a.mv[r]) + 2 * i;
    my[r] = __ldg(mv);
    mx[r] = __ldg(mv + 1);
    y0[r] = N * by + (my[r] >> 3) - (TAPS / 2 - 1);
    x0[r] = N * bx + (mx[r] >> 3) - (TAPS / 2 - 1);
    inside[r] = y0[r] >= 0 && x0[r] >= 0 && y0[r] + WIN <= h && x0[r] + WIN <= w;
  }
  uint8_t* const win = smem;
  uint8_t* const pred = win + 2 * R * WIN_BYTES;
  uint8_t* const src = pred + 2 * TILE;
  uint8_t* const out = src + 2 * TILE;
  int32_t* const counts = reinterpret_cast<int32_t*>(out + 2 * TILE);

  // ---- 1. the windows and the source blocks ---------------------------------
  mctc::Staged staged[2][R];
#pragma unroll
  for (int p = 0; p < 2; ++p) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const uint8_t* ref = reinterpret_cast<const uint8_t*>(a.ref[r][p]);
      uint8_t* const dst = win + (R * p + r) * WIN_BYTES;
      if (inside[r]) {
        const uint8_t* origin = ref + static_cast<size_t>(y0[r]) * w + x0[r];
        mctc::stage_window(origin, w, WIN, WIN, nthreads, dst, WS);
        staged[p][r] = {dst, static_cast<unsigned>(reinterpret_cast<uintptr_t>(origin) & 15),
                        static_cast<unsigned>(w & 15)};
      } else {
        stage_clamped(ref, h, w, y0[r], x0[r], nthreads, dst);
        staged[p][r] = {dst, 0u, 0u};
      }
    }
  }
  stage_source(a.cur, w, by, bx, nthreads, src);
  mctc::Bands bands[R];
#pragma unroll
  for (int r = 0; r < R; ++r) bands[r] = mctc::bands<TAPS>(mx[r] & 7, my[r] & 7);
  mctc::cp_async_wait_all();
  __syncthreads();

  // ---- 2. the predictions: task k is plane k >> 2, strip (k >> 1) & 1, step k & 1
  // store_rows puts output row y at y * w: w = B lays the prediction out as
  // residual_tile reads it, the two strips filling the first 32 bytes of a row.
  // A B frame's task runs both references' products on its tile.
  mctc::Geom g = mctc::geometry(N, N, 1);
  g.w = B;
  for (int k = threadIdx.x >> 5; k < 8; k += nthreads >> 5) {
    const int p = k >> 2, q = k & 1;
    mctc::strip_task<R == 2>(g, staged[p][0], staged[p][R - 1], (k >> 1) & 1, q, q + 1,
                             bands[0], bands[R - 1], pred + p * TILE);
  }
  __syncthreads();
  code_and_store(a.q, a.rec, a.nnz, w, by, bx, nthreads, src, pred, out, counts);
}

// KERNEL4[f][t] (H.265 table 8-12) from mc_tc.cuh's packed bytes.
__device__ __forceinline__ int chroma_tap(uint64_t taps, int t) {
  return static_cast<int8_t>(taps >> (8 * t));
}

// Step 2 of the per-PU instance: block (by, bx) of both planes predicted
// from one reference, each (32 / k)-square tile at its own MV, on the CUDA
// cores.  Task j is plane p, column x and rows 4 q .. 4 q + 3, which lie in
// one tile (a tile has 4 rows or more): the 7 window rows from the plane
// through the read-only cache, rows and columns clamped to its edges, the
// horizontal pass stored to int16, then the vertical pass, rounded and
// clipped into the prediction tile.  B5's tensor-core strip takes one
// fraction a 16-column strip, and a 4x4 tile has its own.
__device__ __forceinline__ void predict_tiles(const ChromaPuArgs& a, long long i, int by,
                                              int bx, int nthreads, uint8_t* pred) {
  const int h = static_cast<int>(a.h), w = static_cast<int>(a.w), k = static_cast<int>(a.k);
  const int side = N / k;
  const int32_t* mv = reinterpret_cast<const int32_t*>(a.mv) + 2 * i * k * k;
  for (int j = threadIdx.x; j < 2 * N * N / 4; j += nthreads) {
    const int x = j % N, q = (j / N) % (N / 4), p = j / (N * N / 4);
    const int t = (4 * q / side) * k + x / side;
    const int my = __ldg(mv + 2 * t), mx = __ldg(mv + 2 * t + 1);
    const int y0 = N * by + 4 * q + (my >> 3) - (TAPS / 2 - 1);
    const int x0 = N * bx + x + (mx >> 3) - (TAPS / 2 - 1);
    const uint64_t fh = mctc::filter_bytes<TAPS>(mx & 7), fv = mctc::filter_bytes<TAPS>(my & 7);
    const uint8_t* ref = reinterpret_cast<const uint8_t*>(a.ref[p]);
    int col[TAPS], mid[4 + TAPS - 1];
#pragma unroll
    for (int c = 0; c < TAPS; ++c) col[c] = clip3(0, w - 1, x0 + c);
#pragma unroll
    for (int r = 0; r < 4 + TAPS - 1; ++r) {
      const uint8_t* row = ref + static_cast<size_t>(clip3(0, h - 1, y0 + r)) * w;
      int s = 0;
#pragma unroll
      for (int c = 0; c < TAPS; ++c) s += chroma_tap(fh, c) * __ldg(row + col[c]);
      mid[r] = static_cast<int16_t>(s);
    }
#pragma unroll
    for (int o = 0; o < 4; ++o) {
      int acc = 0;
#pragma unroll
      for (int c = 0; c < TAPS; ++c) acc += chroma_tap(fv, c) * mid[o + c];
      pred[p * TILE + (4 * q + o) * B + x] = static_cast<uint8_t>(clip3(0, 255, (acc + 2048) >> 12));
    }
  }
}

// The per-PU instance's CTA body: block i of both planes, each tile at its
// own MV (step 2 above), then code_block's steps 3 and 4.
__device__ __forceinline__ void code_block_pu(const ChromaPuArgs& a, long long i, int nthreads,
                                              uint8_t* smem) {
  const int w = static_cast<int>(a.w), gc = w / N;
  const int by = static_cast<int>(i / gc), bx = static_cast<int>(i - static_cast<long long>(by) * gc);
  uint8_t* const pred = smem;
  uint8_t* const src = pred + 2 * TILE;
  uint8_t* const out = src + 2 * TILE;
  int32_t* const counts = reinterpret_cast<int32_t*>(out + 2 * TILE);
  stage_source(a.cur, w, by, bx, nthreads, src);
  predict_tiles(a, i, by, bx, nthreads, pred);
  __syncthreads();
  code_and_store(a.q, a.rec, a.nnz, w, by, bx, nthreads, src, pred, out, counts);
}

}  // namespace chroma
}  // namespace

// ---- the kernel and its C entry ---------------------------------------------------

namespace {

__global__ void __launch_bounds__(chroma::NTHREADS, 2) chroma_p_kernel(const ChromaArgs a) {
  __shared__ __align__(16) uint8_t smem[chroma::SMEM<1>];
  chroma::code_block(a, blockIdx.x, blockDim.x, smem);
}

__global__ void __launch_bounds__(chroma::NTHREADS, 2) chroma_b_kernel(const ChromaBiArgs a) {
  __shared__ __align__(16) uint8_t smem[chroma::SMEM<2>];
  chroma::code_block(a, blockIdx.x, blockDim.x, smem);
}

__global__ void __launch_bounds__(chroma::NTHREADS, 2) chroma_pu_kernel(const ChromaPuArgs a) {
  __shared__ __align__(16) uint8_t smem[chroma::SMEM_PU];
  chroma::code_block_pu(a, blockIdx.x, blockDim.x, smem);
}

// Zeroes nnz[0..1], then launches kernel, one CTA a 32x32 block, on the
// stream, and returns cudaGetLastError() (cudaErrorInvalidValue for a shape
// or a quantizer it does not take: h and w multiples of 32 up to 2^16; the
// caller checks 1 <= qscale < 2^15 and 0 <= qoffset < 2^15).
template <class Args>
int launch(const Args& a, void (*kernel)(const Args)) {
  if (a.h < chroma::N || a.w < chroma::N || a.h % chroma::N || a.w % chroma::N
      || a.h > (1 << 16) || a.w > (1 << 16) || a.q[1] < 16 || a.q[1] > 27 || a.q[4] < 1
      || a.q[4] > 31 || a.device < 0 || a.device >= (1LL << 31))
    return cudaErrorInvalidValue;
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != a.device) err = cudaSetDevice(static_cast<int>(a.device));
  if (err != cudaSuccess) return err;
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(a.stream);
  err = cudaMemsetAsync(reinterpret_cast<void*>(a.nnz), 0, 2 * sizeof(int32_t), s);
  if (err != cudaSuccess) return err;
  const long long n = (a.h / chroma::N) * (a.w / chroma::N);
  kernel<<<static_cast<unsigned>(n), chroma::NTHREADS, 0, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// A P frame's chroma, from one reference.
extern "C" int hevc_chroma_p_fused(const ChromaArgs* args) {
  return launch(*args, chroma_p_kernel);
}

// A B frame's chroma, from two references at their own MVs.
extern "C" int hevc_chroma_b_fused(const ChromaBiArgs* args) {
  return launch(*args, chroma_b_kernel);
}

// A P frame's chroma, from one reference at an MV a (32 / k)-square tile.
extern "C" int hevc_chroma_pu_fused(const ChromaPuArgs* args) {
  const long long k = args->k;
  if (k != 1 && k != 2 && k != 4 && k != 8) return cudaErrorInvalidValue;
  return launch(*args, chroma_pu_kernel);
}
