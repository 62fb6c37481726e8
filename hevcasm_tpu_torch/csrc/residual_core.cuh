// The residual stage shared by the fused CTU kernels (K2 inter_fused.cu, B3
// bi_fused.cu), and the integer helpers they share.
//
// residual_core_8x8 codes one 64x64 CTU held in shared memory against its
// prediction, with 8x8 TUs, as hevcasm_tpu/kernels/residual_pallas.py
// residual_core_stacked does:
//
//   5. 8x8 forward DCT (shifts 2 and 9, int16 wrap after each pass);
//   6. quantize, per-TU nnz and Exp-Golomb bits 2*floor(log2|q|) + 3;
//   7. dequantize, inverse DCT (shifts 7 and 12, clipped to int16), add the
//      prediction and clip to 8 bits.
//
// All arithmetic is int32.  The quantizer products are formed in uint32 so
// that an out-of-range parameter wraps as two's-complement int32 does in
// the reference instead of overflowing a signed int.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int B = 64;           // CTU size
constexpr int NT = 256;         // threads per block of the fused kernels
constexpr int TU = 8;
constexpr int NTU = B / TU;     // TUs per CTU side

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

// Stages 5-7 for one CTU, run by all NT threads of the block.  s_src and
// s_pred are (B, B) uint8 with row stride B; s_work is 2 * B * B ints of
// scratch; s_nnz and s_bits are NTU * NTU ints.  The caller synchronises
// after writing s_pred and before s_work is free.  Writes out (B, B) uint8
// and nnz_out, bits_out (NTU * NTU) int32 of this CTU.
__device__ __forceinline__ void residual_core_8x8(
    const uint8_t* s_src, const uint8_t* s_pred, int* s_work, int* s_nnz,
    int* s_bits, uint8_t* __restrict__ out, int32_t* __restrict__ nnz_out,
    int32_t* __restrict__ bits_out, int qscale, int qshift, int qoffset,
    int dscale, int dshift) {
  const int t = threadIdx.x;
  int* s_a = s_work;           // (B, B) int32
  int* s_b = s_work + B * B;   // (B, B) int32
  if (t < NTU * NTU) {
    s_nnz[t] = 0;
    s_bits[t] = 0;
  }

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
    nnz_out[t] = s_nnz[t];
    bits_out[t] = s_bits[t];
  }
}

}  // namespace
