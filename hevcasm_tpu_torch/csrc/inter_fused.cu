// Kernel K2: quarter-pel refinement fused with the 8x8 residual pipeline.
//
// Replaces hevcasm_tpu/kernels/interp_pallas.py inter_ctu_fused_dma
// (_inter_kernel_dma -> _group_body -> residual_pallas.py
// residual_core_stacked).  Per 64x64 CTU, with nothing written to device
// memory between the steps:
//
//   1. fetch the 71x71 window at offsets[i] straight from the plane (a start
//      past the plane's end is clamped so the window fits);
//   2. 4 horizontal 8-tap passes (one per xf), each wrapped to int16;
//   3. 16 vertical accumulations, scored pixel-parallel by QPEL_SCORE
//      sum |acc - (src << 12)| >> 4 on the pre-clip accumulator and summed
//      by a block reduction; the first minimum in yf*4 + xf order wins;
//   4. the winner is recomputed: pred = clip((acc + 2048) >> 12, 0, 255);
//   5. 8x8 forward DCT (shifts 2 and 9, int16 wrap after each pass);
//   6. quantize, per-TU nnz and Exp-Golomb bits 2*floor(log2|q|) + 3;
//   7. dequantize, inverse DCT (shifts 7 and 12, clipped to int16), add the
//      prediction and clip to 8 bits.
//
// All arithmetic is int32.  The quantizer products are formed in uint32 so
// that an out-of-range parameter wraps as two's-complement int32 does in
// the reference instead of overflowing a signed int.
//
// What bounds it on the H100: per CTU about 0.7 M multiply-adds (the 16
// vertical candidates dominate) against 9 KB of input, so neither compute
// nor bandwidth is near its limit; latency is: one block does a CTU's work
// in seven phases separated by barriers.  The 16 full candidate planes
// (256 KB of int32) do not fit in shared memory, so the design keeps only
// the four int16 horizontal passes (36 KB) there, scores every candidate
// from them, and recomputes the winner.  About 47 KB of shared memory per
// block lets four CTUs share an SM, so a 510-CTU frame runs in one wave.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int B = 64;           // CTU size
constexpr int WIN = B + 7;      // refine window: 71 x 71
constexpr int WSTR = 72;        // window row stride in shared memory
constexpr int NT = 256;         // threads per block
constexpr int NWARP = NT / 32;
constexpr int TU = 8;
constexpr int NTU = B / TU;     // TUs per CTU side

// HEVC luma quarter-pel filters, KERNEL8[frac][tap].
__constant__ int K8[4][8] = {
    {0, 0, 0, 64, 0, 0, 0, 0},
    {-1, 4, -10, 58, 17, -5, 1, 0},
    {-1, 4, -11, 40, 40, -11, 4, -1},
    {0, 1, -5, 17, 58, -10, 4, -1},
};

// HEVC 8-point DCT matrix, T8[k][j].
__constant__ int T8[8][8] = {
    {64, 64, 64, 64, 64, 64, 64, 64},
    {89, 75, 50, 18, -18, -50, -75, -89},
    {83, 36, -36, -83, -83, -36, 36, 83},
    {75, -18, -89, -50, 50, 89, 18, -75},
    {64, -64, -64, 64, 64, -64, -64, 64},
    {50, -89, 18, 75, -75, -18, 89, -50},
    {36, -83, 83, -36, -36, 83, -83, 36},
    {18, -50, 75, -89, 89, -75, 50, -18},
};

__device__ __forceinline__ int wrap16(int v) {
  return static_cast<int>(static_cast<uint32_t>(v) << 16) >> 16;
}

__device__ __forceinline__ int clip3(int lo, int hi, int v) {
  return min(max(v, lo), hi);
}

// HEVC forward quantization of one coefficient (quantize.c semantics).
__device__ __forceinline__ int quantize(int c, int qscale, int qshift,
                                        int qoffset) {
  const uint32_t a = static_cast<uint32_t>(c < 0 ? -c : c);
  const uint32_t t = a * static_cast<uint32_t>(qscale) +
                     (static_cast<uint32_t>(qoffset) << (qshift - 16));
  const int q = static_cast<int>(t) >> qshift;
  return clip3(-32768, 32767, c < 0 ? -q : q);
}

__device__ __forceinline__ int dequantize(int q, int dscale, int dshift) {
  const uint32_t t = static_cast<uint32_t>(q) * static_cast<uint32_t>(dscale) +
                     (1u << (dshift - 1));
  return clip3(-32768, 32767, static_cast<int>(t) >> dshift);
}

__device__ __forceinline__ int egk_bits(int q) {
  const uint32_t a = static_cast<uint32_t>(q < 0 ? -q : q);
  return a ? 2 * (31 - __clz(a)) + 3 : 0;
}

__global__ void __launch_bounds__(NT)
inter_fused_kernel(const uint8_t* __restrict__ src,
                   const uint8_t* __restrict__ plane,
                   const int32_t* __restrict__ offsets,
                   uint8_t* __restrict__ rec, int32_t* __restrict__ frac_out,
                   int32_t* __restrict__ cost_out, int32_t* __restrict__ nnz_out,
                   int32_t* __restrict__ bits_out, int plane_h, int plane_w,
                   int qscale, int qshift, int qoffset, int dscale,
                   int dshift) {
  // s_win holds the window until the H passes are done, then the
  // prediction; s_hp holds the H passes until the winner is recomputed,
  // then two int32 64x64 planes of the residual pipeline.
  __shared__ __align__(16) uint8_t s_win[WIN * WSTR];
  __shared__ __align__(16) uint8_t s_src[B * B];
  __shared__ __align__(16) int16_t s_hp[4 * WIN * B];
  __shared__ int s_red[NWARP][16];
  __shared__ int s_cost[16];
  __shared__ int s_best;
  __shared__ int s_nnz[NTU * NTU];
  __shared__ int s_bits[NTU * NTU];

  const int i = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;

  // ---- 1. window and source ---------------------------------------------
  const int y0 = clip3(0, plane_h - WIN, offsets[2 * i]);
  const int x0 = clip3(0, plane_w - WIN, offsets[2 * i + 1]);
  for (int k = t; k < WIN * WIN; k += NT) {
    const int r = k / WIN, c = k - r * WIN;
    s_win[r * WSTR + c] =
        plane[static_cast<size_t>(y0 + r) * plane_w + x0 + c];
  }
  const uint8_t* s = src + static_cast<size_t>(i) * B * B;
  for (int k = t; k < B * B; k += NT) s_src[k] = s[k];
  if (t < NTU * NTU) {
    s_nnz[t] = 0;
    s_bits[t] = 0;
  }
  __syncthreads();

  // ---- 2. horizontal passes: s_hp[xf][r][c], int16-wrapped --------------
  for (int k = t; k < 4 * WIN * B; k += NT) {
    const int xf = k / (WIN * B);
    const int rem = k - xf * WIN * B;
    const int r = rem / B, c = rem - r * B;
    const uint8_t* w = s_win + r * WSTR + c;
    int v = 0;
#pragma unroll
    for (int tap = 0; tap < 8; ++tap) v += K8[xf][tap] * w[tap];
    s_hp[k] = static_cast<int16_t>(wrap16(v));
  }
  __syncthreads();

  // ---- 3. vertical accumulations + QPEL_SCORE ---------------------------
  // Thread t owns column x and the 16 rows [16*yg, 16*yg + 16).
  const int x = t % B, yg = t / B;
  int cost[16];
#pragma unroll
  for (int c = 0; c < 16; ++c) cost[c] = 0;
#pragma unroll
  for (int xf = 0; xf < 4; ++xf) {
    int col[16 + 7];
    const int16_t* hp = s_hp + (xf * WIN + 16 * yg) * B + x;
#pragma unroll
    for (int r = 0; r < 16 + 7; ++r) col[r] = hp[r * B];
#pragma unroll
    for (int yy = 0; yy < 16; ++yy) {
      const int s12 = static_cast<int>(s_src[(16 * yg + yy) * B + x]) << 12;
#pragma unroll
      for (int yf = 0; yf < 4; ++yf) {
        int acc = 0;
#pragma unroll
        for (int tap = 0; tap < 8; ++tap) acc += K8[yf][tap] * col[yy + tap];
        cost[yf * 4 + xf] += abs(acc - s12) >> 4;
      }
    }
  }
#pragma unroll
  for (int c = 0; c < 16; ++c) {
    int v = cost[c];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) s_red[warp][c] = v;
  }
  __syncthreads();
  if (t < 16) {
    int v = 0;
#pragma unroll
    for (int w = 0; w < NWARP; ++w) v += s_red[w][t];
    s_cost[t] = v;
  }
  __syncthreads();
  if (t == 0) {
    // First minimum: the minimum value, then the smallest index holding it.
    int best = s_cost[0];
    for (int c = 1; c < 16; ++c) best = min(best, s_cost[c]);
    int idx = 0;
    while (s_cost[idx] != best) ++idx;
    s_best = idx;
    frac_out[i] = idx;
    cost_out[i] = best;
  }
  __syncthreads();

  // ---- 4. the winning prediction, into s_win ----------------------------
  uint8_t* s_pred = s_win;  // (B, B), row stride B
  {
    const int yf = s_best >> 2, xf = s_best & 3;
    const int16_t* hp = s_hp + (xf * WIN + 16 * yg) * B + x;
#pragma unroll 4
    for (int yy = 0; yy < 16; ++yy) {
      int acc = 0;
#pragma unroll
      for (int tap = 0; tap < 8; ++tap) acc += K8[yf][tap] * hp[(yy + tap) * B];
      s_pred[(16 * yg + yy) * B + x] =
          static_cast<uint8_t>(clip3(0, 255, (acc + 2048) >> 12));
    }
  }
  __syncthreads();

  int* s_a = reinterpret_cast<int*>(s_hp);   // (B, B) int32
  int* s_b = s_a + B * B;                    // (B, B) int32

  // ---- 5. forward pass 1 (rows): s_a[p][8b + k] ---------------------------
  for (int item = t; item < B * NTU; item += NT) {
    const int b = item % NTU, p = item / NTU;
    int res[TU];
#pragma unroll
    for (int j = 0; j < TU; ++j)
      res[j] = static_cast<int>(s_src[p * B + TU * b + j]) -
               static_cast<int>(s_pred[p * B + TU * b + j]);
#pragma unroll
    for (int k = 0; k < TU; ++k) {
      int v = 0;
#pragma unroll
      for (int j = 0; j < TU; ++j) v += T8[k][j] * res[j];
      s_a[p * B + TU * b + k] = wrap16((v + 2) >> 2);
    }
  }
  __syncthreads();

  // ---- 6. forward pass 2 (columns), quantize, count, dequantize, inverse
  // pass 1: each thread owns one column of one TU row band --------------
  for (int item = t; item < B * NTU; item += NT) {
    const int col = item % B, a = item / B;
    int in[TU];
#pragma unroll
    for (int r = 0; r < TU; ++r) in[r] = s_a[(TU * a + r) * B + col];
    int dq[TU];
    int cnt = 0, bits = 0;
#pragma unroll
    for (int m = 0; m < TU; ++m) {
      int v = 0;
#pragma unroll
      for (int r = 0; r < TU; ++r) v += T8[m][r] * in[r];
      const int q = quantize(wrap16((v + 256) >> 9), qscale, qshift, qoffset);
      cnt += q != 0;
      bits += egk_bits(q);
      dq[m] = dequantize(q, dscale, dshift);
    }
#pragma unroll
    for (int k = 0; k < TU; ++k) {
      int v = 0;
#pragma unroll
      for (int m = 0; m < TU; ++m) v += T8[m][k] * dq[m];
      s_b[(TU * a + k) * B + col] = clip3(-32768, 32767, (v + 64) >> 7);
    }
    atomicAdd(&s_nnz[a * NTU + col / TU], cnt);
    atomicAdd(&s_bits[a * NTU + col / TU], bits);
  }
  __syncthreads();

  // ---- 7. inverse pass 2 (rows), add, clip, store -------------------------
  uint8_t* out = rec + static_cast<size_t>(i) * B * B;
  for (int item = t; item < B * NTU; item += NT) {
    const int b = item % NTU, p = item / NTU;
    int in[TU];
#pragma unroll
    for (int c = 0; c < TU; ++c) in[c] = s_b[p * B + TU * b + c];
#pragma unroll
    for (int k = 0; k < TU; ++k) {
      int v = 0;
#pragma unroll
      for (int c = 0; c < TU; ++c) v += in[c] * T8[c][k];
      const int r2 = clip3(-32768, 32767, (v + 2048) >> 12);
      out[p * B + TU * b + k] = static_cast<uint8_t>(
          clip3(0, 255, static_cast<int>(s_pred[p * B + TU * b + k]) + r2));
    }
  }
  if (t < NTU * NTU) {
    nnz_out[static_cast<size_t>(i) * NTU * NTU + t] = s_nnz[t];
    bits_out[static_cast<size_t>(i) * NTU * NTU + t] = s_bits[t];
  }
}

}  // namespace

// src (n, 64, 64) uint8; plane (plane_h, plane_w) uint8 contiguous with
// plane_h, plane_w >= 71; offsets (n, 2) int32 window top-left [y, x];
// outputs rec (n, 64, 64) uint8, frac (n,), cost (n,), nnz (n, 8, 8),
// bits (n, 8, 8) int32.  The caller checks the quantizer ranges
// (1 <= qscale < 2^15, 16 <= qshift <= 27, 0 <= qoffset < 2^15,
// 1 <= dshift <= 31).  Launches on `stream`, returns cudaGetLastError().
extern "C" int hevc_inter_fused(const uint8_t* src, const uint8_t* plane,
                                const int32_t* offsets, uint8_t* rec,
                                int32_t* frac, int32_t* cost, int32_t* nnz,
                                int32_t* bits, int n, int plane_h, int plane_w,
                                int qscale, int qshift, int qoffset, int dscale,
                                int dshift, int device, void* stream) {
  if (plane_h < WIN || plane_w < WIN || qshift < 16 || qshift > 27 ||
      dshift < 1 || dshift > 31)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n == 0) return cudaGetLastError();
  inter_fused_kernel<<<n, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      src, plane, offsets, rec, frac, cost, nnz, bits, plane_h, plane_w,
      qscale, qshift, qoffset, dscale, dshift);
  return cudaGetLastError();
}
