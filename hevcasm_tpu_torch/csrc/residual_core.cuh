// The residual stage shared by the CTU kernels (K2 inter_fused.cu, B3
// bi_fused.cu, B4 residual_ctu.cu), and the integer helpers they share.
//
// residual_core<TU, DST> codes one 64x64 CTU held in shared memory against
// its prediction, with TU x TU transform units (TU in {4, 8, 16, 32}; DST
// selects the 4x4 DST-VII), as hevcasm_tpu/kernels/residual_pallas.py
// residual_core (and, at TU = 8, residual_core_stacked) does:
//
//   5. forward transform, rows then columns (shifts log2(TU) - 1 and
//      log2(TU) + 6, int16 wrap after each pass);
//   6. quantize, per-TU nnz and Exp-Golomb bits 2*floor(log2|q|) + 3;
//   7. dequantize, inverse transform, columns then rows (shifts 7 and 12,
//      clipped to int16), add the prediction and clip to 8 bits.
//
// The passes run one thread per TU-long row or column of a TU band, with
// the band's values in registers.
//
// All arithmetic is int32.  The quantizer products are formed in uint32 so
// that an out-of-range parameter wraps as two's-complement int32 does in
// the reference instead of overflowing a signed int.  Every matrix entry is
// read at an index known at compile time (the loops are unrolled), so the
// constant cache serves each read to the whole warp at once.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int B = 64;           // CTU size
constexpr int NT = 256;         // threads per block of the CTU kernels

// The 32-point HEVC transform matrix; the N-point matrix is its rows
// 0, 32/N, 2*32/N, ... cut to N columns (ops/transform.dct_matrix).
__constant__ int DCT32[32][32] = {
    {64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64},
    {90, 90, 88, 85, 82, 78, 73, 67, 61, 54, 46, 38, 31, 22, 13, 4, -4, -13, -22, -31, -38, -46, -54, -61, -67, -73, -78, -82, -85, -88, -90, -90},
    {90, 87, 80, 70, 57, 43, 25, 9, -9, -25, -43, -57, -70, -80, -87, -90, -90, -87, -80, -70, -57, -43, -25, -9, 9, 25, 43, 57, 70, 80, 87, 90},
    {90, 82, 67, 46, 22, -4, -31, -54, -73, -85, -90, -88, -78, -61, -38, -13, 13, 38, 61, 78, 88, 90, 85, 73, 54, 31, 4, -22, -46, -67, -82, -90},
    {89, 75, 50, 18, -18, -50, -75, -89, -89, -75, -50, -18, 18, 50, 75, 89, 89, 75, 50, 18, -18, -50, -75, -89, -89, -75, -50, -18, 18, 50, 75, 89},
    {88, 67, 31, -13, -54, -82, -90, -78, -46, -4, 38, 73, 90, 85, 61, 22, -22, -61, -85, -90, -73, -38, 4, 46, 78, 90, 82, 54, 13, -31, -67, -88},
    {87, 57, 9, -43, -80, -90, -70, -25, 25, 70, 90, 80, 43, -9, -57, -87, -87, -57, -9, 43, 80, 90, 70, 25, -25, -70, -90, -80, -43, 9, 57, 87},
    {85, 46, -13, -67, -90, -73, -22, 38, 82, 88, 54, -4, -61, -90, -78, -31, 31, 78, 90, 61, 4, -54, -88, -82, -38, 22, 73, 90, 67, 13, -46, -85},
    {83, 36, -36, -83, -83, -36, 36, 83, 83, 36, -36, -83, -83, -36, 36, 83, 83, 36, -36, -83, -83, -36, 36, 83, 83, 36, -36, -83, -83, -36, 36, 83},
    {82, 22, -54, -90, -61, 13, 78, 85, 31, -46, -90, -67, 4, 73, 88, 38, -38, -88, -73, -4, 67, 90, 46, -31, -85, -78, -13, 61, 90, 54, -22, -82},
    {80, 9, -70, -87, -25, 57, 90, 43, -43, -90, -57, 25, 87, 70, -9, -80, -80, -9, 70, 87, 25, -57, -90, -43, 43, 90, 57, -25, -87, -70, 9, 80},
    {78, -4, -82, -73, 13, 85, 67, -22, -88, -61, 31, 90, 54, -38, -90, -46, 46, 90, 38, -54, -90, -31, 61, 88, 22, -67, -85, -13, 73, 82, 4, -78},
    {75, -18, -89, -50, 50, 89, 18, -75, -75, 18, 89, 50, -50, -89, -18, 75, 75, -18, -89, -50, 50, 89, 18, -75, -75, 18, 89, 50, -50, -89, -18, 75},
    {73, -31, -90, -22, 78, 67, -38, -90, -13, 82, 61, -46, -88, -4, 85, 54, -54, -85, 4, 88, 46, -61, -82, 13, 90, 38, -67, -78, 22, 90, 31, -73},
    {70, -43, -87, 9, 90, 25, -80, -57, 57, 80, -25, -90, -9, 87, 43, -70, -70, 43, 87, -9, -90, -25, 80, 57, -57, -80, 25, 90, 9, -87, -43, 70},
    {67, -54, -78, 38, 85, -22, -90, 4, 90, 13, -88, -31, 82, 46, -73, -61, 61, 73, -46, -82, 31, 88, -13, -90, -4, 90, 22, -85, -38, 78, 54, -67},
    {64, -64, -64, 64, 64, -64, -64, 64, 64, -64, -64, 64, 64, -64, -64, 64, 64, -64, -64, 64, 64, -64, -64, 64, 64, -64, -64, 64, 64, -64, -64, 64},
    {61, -73, -46, 82, 31, -88, -13, 90, -4, -90, 22, 85, -38, -78, 54, 67, -67, -54, 78, 38, -85, -22, 90, 4, -90, 13, 88, -31, -82, 46, 73, -61},
    {57, -80, -25, 90, -9, -87, 43, 70, -70, -43, 87, 9, -90, 25, 80, -57, -57, 80, 25, -90, 9, 87, -43, -70, 70, 43, -87, -9, 90, -25, -80, 57},
    {54, -85, -4, 88, -46, -61, 82, 13, -90, 38, 67, -78, -22, 90, -31, -73, 73, 31, -90, 22, 78, -67, -38, 90, -13, -82, 61, 46, -88, 4, 85, -54},
    {50, -89, 18, 75, -75, -18, 89, -50, -50, 89, -18, -75, 75, 18, -89, 50, 50, -89, 18, 75, -75, -18, 89, -50, -50, 89, -18, -75, 75, 18, -89, 50},
    {46, -90, 38, 54, -90, 31, 61, -88, 22, 67, -85, 13, 73, -82, 4, 78, -78, -4, 82, -73, -13, 85, -67, -22, 88, -61, -31, 90, -54, -38, 90, -46},
    {43, -90, 57, 25, -87, 70, 9, -80, 80, -9, -70, 87, -25, -57, 90, -43, -43, 90, -57, -25, 87, -70, -9, 80, -80, 9, 70, -87, 25, 57, -90, 43},
    {38, -88, 73, -4, -67, 90, -46, -31, 85, -78, 13, 61, -90, 54, 22, -82, 82, -22, -54, 90, -61, -13, 78, -85, 31, 46, -90, 67, 4, -73, 88, -38},
    {36, -83, 83, -36, -36, 83, -83, 36, 36, -83, 83, -36, -36, 83, -83, 36, 36, -83, 83, -36, -36, 83, -83, 36, 36, -83, 83, -36, -36, 83, -83, 36},
    {31, -78, 90, -61, 4, 54, -88, 82, -38, -22, 73, -90, 67, -13, -46, 85, -85, 46, 13, -67, 90, -73, 22, 38, -82, 88, -54, -4, 61, -90, 78, -31},
    {25, -70, 90, -80, 43, 9, -57, 87, -87, 57, -9, -43, 80, -90, 70, -25, -25, 70, -90, 80, -43, -9, 57, -87, 87, -57, 9, 43, -80, 90, -70, 25},
    {22, -61, 85, -90, 73, -38, -4, 46, -78, 90, -82, 54, -13, -31, 67, -88, 88, -67, 31, 13, -54, 82, -90, 78, -46, 4, 38, -73, 90, -85, 61, -22},
    {18, -50, 75, -89, 89, -75, 50, -18, -18, 50, -75, 89, -89, 75, -50, 18, 18, -50, 75, -89, 89, -75, 50, -18, -18, 50, -75, 89, -89, 75, -50, 18},
    {13, -38, 61, -78, 88, -90, 85, -73, 54, -31, 4, 22, -46, 67, -82, 90, -90, 82, -67, 46, -22, -4, 31, -54, 73, -85, 90, -88, 78, -61, 38, -13},
    {9, -25, 43, -57, 70, -80, 87, -90, 90, -87, 80, -70, 57, -43, 25, -9, -9, 25, -43, 57, -70, 80, -87, 90, -90, 87, -80, 70, -57, 43, -25, 9},
    {4, -13, 22, -31, 38, -46, 54, -61, 67, -73, 78, -82, 85, -88, 90, -90, 90, -90, 88, -85, 82, -78, 73, -67, 61, -54, 46, -38, 31, -22, 13, -4},
};

// DST-VII 4x4 (H.265 equation 8-318), for 4x4 intra luma TUs.
__constant__ int DST4[4][4] = {
    {29, 55, 74, 84},
    {74, 74, 0, -74},
    {84, -29, -74, 55},
    {55, -84, 74, -29},
};

// Entry [k][j] of the TU-point transform matrix.
template <int TU, bool DST>
__device__ __forceinline__ int tmat(int k, int j) {
  if constexpr (DST) {
    return DST4[k][j];
  } else {
    return DCT32[k * (32 / TU)][j];
  }
}

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
// scratch; s_nnz and s_bits are (B / TU)^2 ints.  The caller synchronises
// after writing s_pred and before s_work is free.  Writes out (B, B) uint8
// and nnz_out (B / TU)^2 int32 of this CTU, and bits_out unless it is null.
template <int TU, bool DST = false>
__device__ __forceinline__ void residual_core(
    const uint8_t* s_src, const uint8_t* s_pred, int* s_work, int* s_nnz,
    int* s_bits, uint8_t* __restrict__ out, int32_t* __restrict__ nnz_out,
    int32_t* __restrict__ bits_out, int qscale, int qshift, int qoffset,
    int dscale, int dshift) {
  static_assert(TU == 4 || TU == 8 || TU == 16 || TU == 32, "TU size");
  static_assert(!DST || TU == 4, "the DST-VII is 4x4 only");
  constexpr int K = B / TU;                      // TUs per CTU side
  constexpr int LOG2 = TU == 4 ? 2 : TU == 8 ? 3 : TU == 16 ? 4 : 5;
  constexpr int S1 = LOG2 - 1, S2 = LOG2 + 6;    // forward shifts
  const int t = threadIdx.x;
  int* s_a = s_work;           // (B, B) int32
  int* s_b = s_work + B * B;   // (B, B) int32
  for (int i = t; i < K * K; i += NT) {
    s_nnz[i] = 0;
    s_bits[i] = 0;
  }

  // ---- 5. forward pass 1 (rows): s_a[p][TU*b + k] -------------------------
  for (int item = t; item < B * K; item += NT) {
    const int b = item % K, p = item / K;
    int res[TU];
#pragma unroll
    for (int j = 0; j < TU; ++j)
      res[j] = static_cast<int>(s_src[p * B + TU * b + j]) -
               static_cast<int>(s_pred[p * B + TU * b + j]);
#pragma unroll
    for (int k = 0; k < TU; ++k) {
      int v = 0;
#pragma unroll
      for (int j = 0; j < TU; ++j) v += tmat<TU, DST>(k, j) * res[j];
      s_a[p * B + TU * b + k] = wrap16((v + (1 << (S1 - 1))) >> S1);
    }
  }
  __syncthreads();

  // ---- 6. forward pass 2 (columns), quantize, count, dequantize, inverse
  // pass 1: each thread owns one column of one TU row band.  Up to 8x8 TUs
  // one pass keeps the column's dequantized levels in registers; larger TUs
  // store them to s_b and run the inverse pass after a barrier, which keeps
  // a thread at one TU-long column (32 ints) instead of two.
  constexpr bool FUSED = TU <= 8;
  int* s_inv = FUSED ? s_b : s_a;            // inverse pass 1 output
  for (int item = t; item < B * K; item += NT) {
    const int col = item % B, a = item / B;
    int in[TU];
#pragma unroll
    for (int r = 0; r < TU; ++r) in[r] = s_a[(TU * a + r) * B + col];
    int dq[FUSED ? TU : 1];
    int cnt = 0, bits = 0;
#pragma unroll
    for (int m = 0; m < TU; ++m) {
      int v = 0;
#pragma unroll
      for (int r = 0; r < TU; ++r) v += tmat<TU, DST>(m, r) * in[r];
      const int q = quantize(wrap16((v + (1 << (S2 - 1))) >> S2), qscale, qshift, qoffset);
      cnt += q != 0;
      bits += egk_bits(q);
      if constexpr (FUSED) {
        dq[m] = dequantize(q, dscale, dshift);
      } else {
        s_b[(TU * a + m) * B + col] = dequantize(q, dscale, dshift);
      }
    }
    if constexpr (FUSED) {
#pragma unroll
      for (int k = 0; k < TU; ++k) {
        int v = 0;
#pragma unroll
        for (int m = 0; m < TU; ++m) v += tmat<TU, DST>(m, k) * dq[m];
        s_inv[(TU * a + k) * B + col] = clip3(-32768, 32767, (v + 64) >> 7);
      }
    }
    atomicAdd(&s_nnz[a * K + col / TU], cnt);
    atomicAdd(&s_bits[a * K + col / TU], bits);
  }
  __syncthreads();
  if constexpr (!FUSED) {
    for (int item = t; item < B * K; item += NT) {
      const int col = item % B, a = item / B;
      int dq[TU];
#pragma unroll
      for (int m = 0; m < TU; ++m) dq[m] = s_b[(TU * a + m) * B + col];
#pragma unroll
      for (int k = 0; k < TU; ++k) {
        int v = 0;
#pragma unroll
        for (int m = 0; m < TU; ++m) v += tmat<TU, DST>(m, k) * dq[m];
        s_inv[(TU * a + k) * B + col] = clip3(-32768, 32767, (v + 64) >> 7);
      }
    }
    __syncthreads();
  }

  // ---- 7. inverse pass 2 (rows), add, clip, store -------------------------
  for (int item = t; item < B * K; item += NT) {
    const int b = item % K, p = item / K;
    int in[TU];
#pragma unroll
    for (int c = 0; c < TU; ++c) in[c] = s_inv[p * B + TU * b + c];
#pragma unroll
    for (int k = 0; k < TU; ++k) {
      int v = 0;
#pragma unroll
      for (int c = 0; c < TU; ++c) v += in[c] * tmat<TU, DST>(c, k);
      const int r2 = clip3(-32768, 32767, (v + 2048) >> 12);
      out[p * B + TU * b + k] = static_cast<uint8_t>(
          clip3(0, 255, static_cast<int>(s_pred[p * B + TU * b + k]) + r2));
    }
  }
  for (int i = t; i < K * K; i += NT) {
    nnz_out[i] = s_nnz[i];
    if (bits_out) bits_out[i] = s_bits[i];
  }
}

}  // namespace
