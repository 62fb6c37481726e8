// Kernel chroma_p_fused: the chroma of a 4:2:0 P frame, both planes, in one
// launch.
//
// Replaces no TPU kernel: hevcasm_tpu codes a P frame's chroma in plain ops
// (encode/video.py _chroma_mc, then _chroma_residual, a plane at a time),
// which the port ran as some 140 small torch ops and launches a plane, with
// the 4x4 transforms as float64 matrix products.  This kernel computes the
// same integers.  For 32x32 chroma block i (the chroma of 64x64 luma CTU i,
// raster order) of each plane, one CTA of 8 warps, with nothing written to
// device memory between the steps:
//
//   1. stages the 35x35 reference window at the block's position plus
//      (mv >> 3) - 1 straight from the (h, w) reference plane, rows and
//      columns past the plane clamped to its edge (pad_frame's edge
//      replication): by 16-byte cp.async (mc_tc.cuh stage_window) where the
//      window lies inside the plane, else sample by sample; and the 32x32
//      source block, 16 bytes a thread;
//   2. predicts it at fraction mv & 7 on both axes with B5's 4-tap
//      tensor-core core (mc_tc.cuh strip_task: a warp a 16-column strip and
//      a 16-row step), the prediction into shared memory;
//   3. codes it with the residual stage K2, B3, B4 and B19 share
//      (residual_core.cuh residual_tile<4>: a warp a 16x16 tile, 4x4 DCT,
//      quantize, per-TU nnz, dequantize, inverse, add and clip, the four
//      passes on mma.sync), at the chroma quantizer the wrapper passes;
//   4. writes the 32x32 reconstruction into the (h, w) output plane, 16
//      bytes a thread, and adds the block's nnz to the plane's count
//      (nnz[0] Cb, nnz[1] Cr) with one atomicAdd; the C entry zeroes the
//      two counts before the launch.
//
// Steps 2 and 3 keep the stride-64 layout their cores were written for
// (B5's output rows w apart, residual_tile's rows B apart), so the cores
// serve this kernel unchanged: the prediction, source and reconstruction
// tiles are 32 rows of 64 bytes in shared memory, and step 4 moves the
// reconstruction to the plane in whole 16-byte rows pieces.
//
// What bounds it on the H100: a 1920x1088 frame's two 960x544 planes are
// 0.52 MB each read twice (source, reference) and written once, 3.1 MB
// (0.0009 ms at 3.35 TB/s; the windows' overlap reads the reference ~1.2
// times, from L2), for 2 x 510 blocks of 5 m16n8k32 products a 16-row step
// of MC and 16 m16n8k16 a 16x16 tile of residual: neither bytes nor
// products.  A call is bound by its latency (the launch, the window's
// trip into shared memory, three barriers and each warp's chain of
// products) and, on the frame's path, by the host: one launch, and
// nothing else, where the plain composition enqueued ~280.

#include "mc_tc.cuh"
#include "residual_core.cuh"

// The C entry's packed argument block (kernels/chroma_fused.py _ARGS: 17
// int64).  Planes j = 0 (Cb) and 1 (Cr): cur[j], ref[j] and rec[j] are (h,
// w) uint8, contiguous and 16-byte aligned; mv is block i's (dy, dx) luma
// quarter-pel MV at mv + 2i (int32); nnz int32[2].
struct ChromaArgs {
  long long cur[2], ref[2], rec[2];
  long long mv, nnz, h, w;
  long long q[5];    // qscale, qshift, qoffset, dscale, dshift
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

// Shared memory of a CTA: two windows, then the prediction, source and
// reconstruction tiles of both planes, then both planes' counts.
constexpr int SMEM = 2 * WIN_BYTES + 3 * 2 * TILE + 2 * COUNTS * 4;

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

// Block i of both planes by a CTA of nthreads threads (a multiple of 32);
// smem holds SMEM bytes, 16-byte aligned.
__device__ __forceinline__ void code_block(const ChromaArgs& a, long long i, int nthreads,
                                           uint8_t* smem) {
  const int h = static_cast<int>(a.h), w = static_cast<int>(a.w), gc = w / N;
  const int by = static_cast<int>(i / gc), bx = static_cast<int>(i - static_cast<long long>(by) * gc);
  const int32_t* mv = reinterpret_cast<const int32_t*>(a.mv) + 2 * i;
  const int my = __ldg(mv), mx = __ldg(mv + 1);
  const int y0 = N * by + (my >> 3) - (TAPS / 2 - 1), x0 = N * bx + (mx >> 3) - (TAPS / 2 - 1);
  const bool inside = y0 >= 0 && x0 >= 0 && y0 + WIN <= h && x0 + WIN <= w;
  uint8_t* const win = smem;
  uint8_t* const pred = win + 2 * WIN_BYTES;
  uint8_t* const src = pred + 2 * TILE;
  uint8_t* const out = src + 2 * TILE;
  int32_t* const counts = reinterpret_cast<int32_t*>(out + 2 * TILE);

  // ---- 1. the windows and the source blocks ---------------------------------
  mctc::Staged staged[2];
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const uint8_t* ref = reinterpret_cast<const uint8_t*>(a.ref[p]);
    if (inside) {
      const uint8_t* origin = ref + static_cast<size_t>(y0) * w + x0;
      mctc::stage_window(origin, w, WIN, WIN, nthreads, win + p * WIN_BYTES, WS);
      staged[p] = {win + p * WIN_BYTES, static_cast<unsigned>(reinterpret_cast<uintptr_t>(origin) & 15),
                   static_cast<unsigned>(w & 15)};
    } else {
      stage_clamped(ref, h, w, y0, x0, nthreads, win + p * WIN_BYTES);
      staged[p] = {win + p * WIN_BYTES, 0u, 0u};
    }
  }
  for (int k = threadIdx.x; k < 2 * N * N / 16; k += nthreads) {
    const int p = k / (N * N / 16), r = (k >> 1) % N, c = 16 * (k & 1);
    *reinterpret_cast<Bytes16*>(src + p * TILE + r * B + c) =
        *reinterpret_cast<const Bytes16*>(reinterpret_cast<const uint8_t*>(a.cur[p]) +
                                          static_cast<size_t>(N * by + r) * w + N * bx + c);
  }
  const mctc::Bands bands = mctc::bands<TAPS>(mx & 7, my & 7);
  mctc::cp_async_wait_all();
  __syncthreads();

  // ---- 2. the predictions: task k is plane k >> 2, strip (k >> 1) & 1, step k & 1
  // store_rows puts output row y at y * w: w = B lays the prediction out as
  // residual_tile reads it, the two strips filling the first 32 bytes of a row.
  mctc::Geom g = mctc::geometry(N, N, 1);
  g.w = B;
  for (int k = threadIdx.x >> 5; k < 8; k += nthreads >> 5) {
    const int p = k >> 2, q = k & 1;
    mctc::strip_task<false>(g, staged[p], staged[p], (k >> 1) & 1, q, q + 1, bands, bands,
                            pred + p * TILE);
  }
  __syncthreads();

  // ---- 3. the residual: task k is plane k >> 2, 16x16 tile ((k >> 1) & 1, k & 1)
  const QParams qp = {static_cast<int>(a.q[0]), static_cast<int>(a.q[1]), static_cast<int>(a.q[2]),
                      static_cast<int>(a.q[3]), static_cast<int>(a.q[4])};
  for (int k = threadIdx.x >> 5; k < 8; k += nthreads >> 5) {
    const int p = k >> 2;
    residual_tile<4>(src + p * TILE, pred + p * TILE, out + p * TILE, counts + p * COUNTS,
                     nullptr, (k >> 1) & 1, k & 1, qp);
  }
  __syncthreads();

  // ---- 4. the reconstruction to the planes, and the counts ------------------
  for (int k = threadIdx.x; k < 2 * N * N / 16; k += nthreads) {
    const int p = k / (N * N / 16), r = (k >> 1) % N, c = 16 * (k & 1);
    *reinterpret_cast<Bytes16*>(reinterpret_cast<uint8_t*>(a.rec[p]) +
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
    if (lane == 0 && v) atomicAdd(reinterpret_cast<int*>(a.nnz) + p, v);
  }
}

}  // namespace chroma
}  // namespace

// ---- the kernel and its C entry ---------------------------------------------------

namespace {

__global__ void __launch_bounds__(chroma::NTHREADS, 2) chroma_p_kernel(const ChromaArgs a) {
  __shared__ __align__(16) uint8_t smem[chroma::SMEM];
  chroma::code_block(a, blockIdx.x, blockDim.x, smem);
}

}  // namespace

// Zeroes nnz[0..1], then launches one CTA a 32x32 block on the stream, and
// returns cudaGetLastError() (cudaErrorInvalidValue for a shape or a
// quantizer it does not take: h and w multiples of 32 up to 2^16; the caller
// checks 1 <= qscale < 2^15 and 0 <= qoffset < 2^15).
extern "C" int hevc_chroma_p_fused(const ChromaArgs* args) {
  const ChromaArgs& a = *args;
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
  chroma_p_kernel<<<static_cast<unsigned>(n), chroma::NTHREADS, 0, s>>>(a);
  return cudaGetLastError();
}
