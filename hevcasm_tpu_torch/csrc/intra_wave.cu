// Kernel intra_wave_fused: one wave of the closed-loop I frame (32x32
// blocks, 8x8 TUs) in one launch.
//
// Replaces no TPU kernel: hevcasm_tpu codes the wavefront I frame in plain
// ops, and so did the port, some 200 small torch launches a wave (the
// neighbour gather, substitution and smoothing, the 35-mode decision as
// float64 products against a 258 x 35,840 weight matrix, the residual, the
// scatter back into the canvas).  This kernel computes the same integers.
// For block i of the wave's span [start, stop) of the wave tables
// (encode/intra_wavefront.py _schedule), one CTA of 8 warps, with nothing
// written to device memory between the steps:
//
//   1. reads the block's 4n + 1 neighbour samples from the tiled canvas
//      through refs[i] (only those lav / aav / cav mark available: an
//      unavailable sample's offset may lie in a block of this very wave),
//      and its source block src[i];
//   2. substitutes the unavailable samples (H.265 8.4.4.2.2: the last
//      available one before each in scan order, a warp's max-scan) and
//      smooths the set (8.4.4.2.3: [1 2 1], or the strong bilinear
//      smoothing where `strong` is set and both edges are near-linear);
//   3. scores the 35 modes as kernels/intra_matrix.intra_mode_decision_t
//      does, without its matrices: for each mode m and 8x8 tile, its
//      accumulator before the shift s_m (planar: 4 taps and n; DC: the sum
//      of the above and left runs and n; angular: (32 - f) ref[k] + f
//      ref[k + 1] + 16, from a per-mode reference run in shared memory that
//      holds the negative-angle projection, on the plain or the filtered
//      set by filterFlag), minus the source << s_m, through H8 X H8 on the
//      CUDA cores; the lanes' |.| >> (s_m + 2) summed over the block, the
//      first minimum over the modes wins.  A thread takes a (mode, tile)
//      at a time; the horizontal modes score the transposed tile against
//      a transposed copy of the source (the same lanes, permuted);
//   4. predicts the winner, clamp(acc >> s, 0, 255): intra_mode_decision_t
//      recovers the same integers by its inverse transform, H (H X H) H =
//      64 X;
//   5. codes it with the residual stage K2, B3, B4, B19 and chroma_p_fused
//      share (residual_core.cuh residual_tile<8>: a warp a 16x16 tile, 8x8
//      DCT, quantize, per-TU nnz, dequantize, inverse, add and clip), at
//      the intra quantizer the wrapper passes;
//   6. writes the reconstruction to canvas tile order[i], adds the block's
//      nnz to *nnz with one atomicAdd, and its mode to modes[i] when modes
//      is not null.
//
// What bounds it on the H100: a block's work is ~0.6 M integer operations
// (35 x 16 tiles of 64 accumulators, two 8-point Hadamard passes and the
// sums) and a few KB of traffic, so a wave of <= 60 blocks (4K; <= 30 at
// 1080p) runs one CTA an SM and takes the latency of one block; the waves
// of a frame form a chain (254 at 4K, 126 at 1080p), each launch waiting
// for the last, so a frame costs the chain's launches and CTA latencies.

#include "residual_core.cuh"

// The C entry's packed argument block (kernels/intra_wave.py _ARGS: 20
// int64).  canvas: the frame's tiled reconstruction, (h w / 1024, 32, 32)
// uint8; src: the source blocks in wave order, (num, 32, 32) uint8; order
// (num,) int64 each block's tile index; refs (num, 129) int64 canvas
// offsets of [left (64), above (64), corner]; lav, aav (num, 64) and cav
// (num,) bool availability; nnz int32[1], added to; modes int32 (num,) or
// 0.  start, stop: the wave's span of the tables; strong: strong intra
// smoothing on.
struct IntraWaveArgs {
  long long canvas, src, order, refs, lav, aav, cav, nnz, modes;
  long long start, stop, num, strong;
  long long q[5];    // qscale, qshift, qoffset, dscale, dshift
  long long device, stream;
};

namespace {
namespace iwave {

constexpr unsigned FULL = 0xffffffffu;
constexpr int N = 32;                      // block side
constexpr int REFS = 4 * N + 1;            // reference samples, in scan order
constexpr int MODES = 35;
constexpr int UNITS = MODES * 16;          // (mode, 8x8 tile) pairs
constexpr int NTHREADS = 256;              // 8 warps
constexpr int CHUNK = 5;                   // scan positions a lane: 32 x 5 >= 129
constexpr int EXT = 3 * N + 2;             // a mode's run ref[k], k = -N .. 2N + 1, at k + N
constexpr int TILE = N * B;                // 32 rows B apart: residual_tile's layout

// Scan order (8.4.4.2.2): position j < 2N is left[2N - 1 - j], 2N the
// corner, j > 2N above[j - 2N - 1].
constexpr int CORNER = 2 * N;

struct alignas(16) Smem {
  uint8_t src[TILE], src_t[TILE], pred[TILE], out[TILE];
  int32_t counts[64];                      // residual_tile's per-TU nnz (rows B / 8 apart)
  int32_t raw[32 * CHUNK];                 // the available samples, by scan position
  int32_t plain[REFS], filt[REFS];         // the substituted and the smoothed sets
  int32_t part[UNITS];                     // each (mode, tile)'s score
  int32_t dc;                              // DC's accumulator before its shift
  uint8_t ext[MODES * EXT];                // each angular mode's reference run
};

struct alignas(16) Bytes16 {
  uint32_t w[4];
};

__device__ __forceinline__ int iabs(int v) { return v < 0 ? -v : v; }

// intraPredAngle of angular mode m (H.265 table 8-5).
__device__ __forceinline__ int angle_of(int m) {
  const int d = m < 18 ? 10 - m : m - 26;
  const int a = iabs(d);
  const int mag = a < 2 ? 2 * a : a < 7 ? 4 * a - 3 : a == 7 ? 26 : 32;
  return d < 0 ? -mag : mag;
}

// filterFlag at nTbS = 32 (intraHorVerDistThres 0): every mode but DC and
// the pure horizontal and vertical ones reads the smoothed set.
__device__ __forceinline__ bool filtered(int m) { return m != 1 && m != 10 && m != 26; }

// In-place 8-point Hadamard transform (Sylvester order) of v[0], v[S], ...
template <int S>
__device__ __forceinline__ void fwht8(int* v) {
#pragma unroll
  for (int stage = 0; stage < 3; ++stage)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (const int h = 1 << stage; !(j & h)) {
        const int a = v[j * S], b = v[(j + h) * S];
        v[j * S] = a + b;
        v[(j + h) * S] = a - b;
      }
}

// ---- steps 1 and 2: the reference sets, by warp 0 --------------------------------
__device__ __forceinline__ void references(const IntraWaveArgs& a, long long row, Smem& sm) {
  const int lane = threadIdx.x & 31;
  const uint8_t* canvas = reinterpret_cast<const uint8_t*>(a.canvas);
  const long long* refs = reinterpret_cast<const long long*>(a.refs) + row * REFS;
  const uint8_t* lav = reinterpret_cast<const uint8_t*>(a.lav) + row * 2 * N;
  const uint8_t* aav = reinterpret_cast<const uint8_t*>(a.aav) + row * 2 * N;
  // The lane's positions j = CHUNK lane + c: availability and offset first
  // (independent loads), then the available samples.
  bool av[CHUNK];
  long long off[CHUNK];
#pragma unroll
  for (int c = 0; c < CHUNK; ++c) {
    const int j = CHUNK * lane + c;
    av[c] = false;
    off[c] = 0;
    if (j < CORNER) {
      av[c] = lav[CORNER - 1 - j];
      off[c] = refs[CORNER - 1 - j];
    } else if (j == CORNER) {
      av[c] = reinterpret_cast<const uint8_t*>(a.cav)[row];
      off[c] = refs[4 * N];
    } else if (j < REFS) {
      av[c] = aav[j - CORNER - 1];
      off[c] = refs[j - 1];
    }
  }
  int last = -1, first = REFS;
#pragma unroll
  for (int c = 0; c < CHUNK; ++c) {
    const int j = CHUNK * lane + c;
    if (av[c]) {
      sm.raw[j] = canvas[off[c]];
      last = j;
      first = min(first, j);
    }
  }
  // Exclusive max-scan of the lanes' last available positions, and the
  // first available position of all.
  int before = -1, total = last;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_xor_sync(FULL, total, o);
    const int f = __shfl_xor_sync(FULL, first, o);
    if (lane & o) before = max(before, t);
    total = max(total, t);
    first = min(first, f);
  }
  __syncwarp();
  // Substitution: the last available sample at or before j, else the
  // first available one, else 128.
  int run = before;
#pragma unroll
  for (int c = 0; c < CHUNK; ++c) {
    const int j = CHUNK * lane + c;
    if (av[c]) run = j;
    if (j < REFS) sm.plain[j] = first < REFS ? sm.raw[run >= 0 ? run : first] : 128;
  }
  __syncwarp();
  const int32_t* p = sm.plain;
  const int corner = p[CORNER], a_end = p[REFS - 1], l_end = p[0];
  const bool strong = a.strong && iabs(corner + a_end - 2 * p[3 * N]) < 8 &&
                      iabs(corner + l_end - 2 * p[N]) < 8;
#pragma unroll
  for (int c = 0; c < CHUNK; ++c) {
    const int j = CHUNK * lane + c;
    if (j >= REFS) continue;
    int v;
    if (strong) {
      // Each edge run interpolated between the corner and its outermost
      // sample; the corner unchanged.
      const int k = j < CORNER ? CORNER - 1 - j : j - CORNER - 1;
      const int end = j < CORNER ? l_end : a_end;
      v = j == CORNER ? corner
                      : k == 2 * N - 1 ? end : ((2 * N - 1 - k) * corner + (k + 1) * end + 32) >> 6;
    } else {
      v = j == 0 || j == REFS - 1 ? p[j] : (p[j - 1] + 2 * p[j] + p[j + 1] + 2) >> 2;
    }
    sm.filt[j] = v;
  }
  // DC: the first n samples of the above and the left run.
  int s = p[CORNER + 1 + lane] + p[CORNER - 1 - lane];
#pragma unroll
  for (int o = 16; o; o >>= 1) s += __shfl_xor_sync(FULL, s, o);
  if (lane == 0) sm.dc = s + N;
}

// Entry kk of angular mode m's run: ref[k] at k = kk - N of 8.4.4.2.6 in
// the mode's own (vertical) frame, the horizontal modes with left and
// above swapped; 0 where no prediction reads it.
__device__ __forceinline__ int run_entry(const Smem& sm, int m, int kk) {
  const int32_t* x = filtered(m) ? sm.filt : sm.plain;
  const int dir = m >= 18 ? 1 : -1;     // main run: above (vertical) or left
  const int k = kk - N;
  if (k == 0) return x[CORNER];
  if (k > 0) return k <= 2 * N ? x[CORNER + dir * k] : 0;
  const int angle = angle_of(m);
  if (angle >= 0 || k < ((N * angle) >> 5)) return 0;
  const int mag = -angle, inv = -((8192 + mag / 2) / mag);
  const int y0 = -1 + ((k * inv + 128) >> 8);
  return y0 < 0 ? x[CORNER] : x[CORNER - dir * (min(y0, 2 * N - 1) + 1)];
}

// ---- step 3: one (mode, tile)'s score ---------------------------------------------
__device__ __forceinline__ int tile_score(const Smem& sm, int m, int t) {
  const int ty = t >> 2, tx = t & 3;
  int d[64];
  int s;
  if (m >= 2) {
    // In the mode's own frame: the horizontal modes' tile transposed,
    // against the transposed source.
    s = 5;
    const int angle = angle_of(m);
    const uint8_t* src = (m >= 18 ? sm.src : sm.src_t) + 8 * ty * B + 8 * tx;
    const uint8_t* ext = sm.ext + m * EXT + N + 8 * tx + 1;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int q = (8 * ty + r + 1) * angle, f = q & 31;
      const uint8_t* run = ext + (q >> 5);
      const uint32_t w0 = lds32(src + r * B), w1 = lds32(src + r * B + 4);
      int prev = run[0];
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int next = run[c + 1];
        const int v = static_cast<int>(((c < 4 ? w0 : w1) >> (8 * (c & 3))) & 255u);
        d[8 * r + c] = (32 - f) * prev + f * next + 16 - (v << 5);
        prev = next;
      }
    }
  } else {
    s = 6;
    const uint8_t* src = sm.src + 8 * ty * B + 8 * tx;
    const int32_t* x = sm.filt;                       // planar reads the smoothed set
    const int top_right = x[CORNER + 1 + N], bottom_left = x[CORNER - 1 - N];
    const int dc = sm.dc;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int y = 8 * ty + r, left = x[CORNER - 1 - y];
      const uint32_t w0 = lds32(src + r * B), w1 = lds32(src + r * B + 4);
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int xx = 8 * tx + c;
        const int v = static_cast<int>(((c < 4 ? w0 : w1) >> (8 * (c & 3))) & 255u);
        const int acc = m == 1 ? dc
                               : (N - 1 - xx) * left + (xx + 1) * top_right +
                                     (N - 1 - y) * x[CORNER + 1 + xx] + (y + 1) * bottom_left + N;
        d[8 * r + c] = acc - (v << 6);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 8; ++r) fwht8<1>(d + 8 * r);
#pragma unroll
  for (int c = 0; c < 8; ++c) fwht8<8>(d + c);
  int sum = 0;
#pragma unroll
  for (int k = 0; k < 64; ++k) sum += iabs(d[k]) >> (s + 2);
  return sum;
}

// ---- step 4: the winner's prediction at (y, x) ------------------------------------
__device__ __forceinline__ int predict(const Smem& sm, int m, int y, int x) {
  int v;
  if (m >= 2) {
    const bool vertical = m >= 18;
    const int yy = vertical ? y : x, xx = vertical ? x : y;
    const int q = (yy + 1) * angle_of(m), f = q & 31;
    const uint8_t* run = sm.ext + m * EXT + N + xx + (q >> 5) + 1;
    v = ((32 - f) * run[0] + f * run[1] + 16) >> 5;
  } else if (m == 1) {
    v = sm.dc >> 6;
  } else {
    const int32_t* p = sm.filt;
    v = ((N - 1 - x) * p[CORNER - 1 - y] + (x + 1) * p[CORNER + 1 + N] +
         (N - 1 - y) * p[CORNER + 1 + x] + (y + 1) * p[CORNER - 1 - N] + N) >> 6;
  }
  return clip3(0, 255, v);
}

// Block `row` of the wave tables by a CTA of nthreads threads (a multiple
// of 32); sm in shared memory, 16-byte aligned.
__device__ __forceinline__ void code_block(const IntraWaveArgs& a, long long row, int nthreads,
                                           Smem& sm) {
  const int warp = threadIdx.x >> 5, nwarps = nthreads >> 5, lane = threadIdx.x & 31;

  // ---- 1-2. the source block (16 bytes a thread) and the reference sets
  const uint8_t* src = reinterpret_cast<const uint8_t*>(a.src) + row * N * N;
  for (int k = threadIdx.x; k < N * N / 16; k += nthreads)
    *reinterpret_cast<Bytes16*>(sm.src + (k >> 1) * B + 16 * (k & 1)) =
        *reinterpret_cast<const Bytes16*>(src + 16 * k);
  if (warp == 0) references(a, row, sm);
  __syncthreads();

  // ---- the angular modes' runs and the transposed source
  for (int k = threadIdx.x; k < (MODES - 2) * EXT; k += nthreads) {
    const int m = 2 + k / EXT, kk = k - (m - 2) * EXT;
    sm.ext[m * EXT + kk] = static_cast<uint8_t>(run_entry(sm, m, kk));
  }
  for (int k = threadIdx.x; k < N * N; k += nthreads)
    sm.src_t[(k & (N - 1)) * B + (k >> 5)] = sm.src[(k >> 5) * B + (k & (N - 1))];
  __syncthreads();

  // ---- 3. every (mode, tile)'s score
  for (int u = threadIdx.x; u < UNITS; u += nthreads) sm.part[u] = tile_score(sm, u >> 4, u & 15);
  __syncthreads();

  // ---- the first minimum over the modes (each warp alone), then 4.
  int key = 0x7fffffff;
  for (int m = lane; m < MODES; m += 32) {
    int score = 0;
#pragma unroll
    for (int t = 0; t < 16; ++t) score += sm.part[16 * m + t];
    key = min(key, 64 * score + m);
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) key = min(key, __shfl_xor_sync(FULL, key, o));
  const int win = key & 63;
  for (int k = threadIdx.x; k < N * N; k += nthreads)
    sm.pred[(k >> 5) * B + (k & (N - 1))] =
        static_cast<uint8_t>(predict(sm, win, k >> 5, k & (N - 1)));
  __syncthreads();

  // ---- 5. the residual: task k is 16x16 tile (k >> 1, k & 1)
  const QParams qp = {static_cast<int>(a.q[0]), static_cast<int>(a.q[1]), static_cast<int>(a.q[2]),
                      static_cast<int>(a.q[3]), static_cast<int>(a.q[4])};
  for (int k = warp; k < 4; k += nwarps)
    residual_tile<8>(sm.src, sm.pred, sm.out, sm.counts, nullptr, k >> 1, k & 1, qp);
  __syncthreads();

  // ---- 6. the reconstruction to its canvas tile, the nnz and the mode
  const long long tile = reinterpret_cast<const long long*>(a.order)[row];
  uint8_t* dst = reinterpret_cast<uint8_t*>(a.canvas) + tile * N * N;
  for (int k = threadIdx.x; k < N * N / 16; k += nthreads)
    *reinterpret_cast<Bytes16*>(dst + 16 * k) =
        *reinterpret_cast<const Bytes16*>(sm.out + (k >> 1) * B + 16 * (k & 1));
  if (warp == 0) {
    // The block's 8x8 TUs are entries (r, c < 4) of the TU grid
    // residual_tile fills (rows B / 8 apart).
    int v = lane < 16 ? sm.counts[(lane >> 2) * (B / 8) + (lane & 3)] : 0;
#pragma unroll
    for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
    if (lane == 0) {
      if (v) atomicAdd(reinterpret_cast<int*>(a.nnz), v);
      if (a.modes) reinterpret_cast<int32_t*>(a.modes)[row] = win;
    }
  }
}

}  // namespace iwave
}  // namespace

// ---- the kernel and its C entry ---------------------------------------------------

namespace {

__global__ void __launch_bounds__(iwave::NTHREADS, 1) intra_wave_kernel(const IntraWaveArgs a) {
  __shared__ iwave::Smem sm;
  iwave::code_block(a, a.start + blockIdx.x, blockDim.x, sm);
}

}  // namespace

// Launches one CTA a block of the span [start, stop) on the stream and
// returns cudaGetLastError() (cudaErrorInvalidValue for a span or a
// quantizer it does not take; the caller checks 1 <= qscale < 2^15 and 0
// <= qoffset < 2^15).  *nnz is added to, not zeroed.
extern "C" int hevc_intra_wave(const IntraWaveArgs* args) {
  const IntraWaveArgs& a = *args;
  if (a.start < 0 || a.stop <= a.start || a.stop > a.num || a.num > (1LL << 24) || a.q[1] < 16
      || a.q[1] > 27 || a.q[4] < 1 || a.q[4] > 31 || a.device < 0 || a.device >= (1LL << 31))
    return cudaErrorInvalidValue;
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != a.device) err = cudaSetDevice(static_cast<int>(a.device));
  if (err != cudaSuccess) return err;
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(a.stream);
  intra_wave_kernel<<<static_cast<unsigned>(a.stop - a.start), iwave::NTHREADS, 0, s>>>(a);
  return cudaGetLastError();
}
