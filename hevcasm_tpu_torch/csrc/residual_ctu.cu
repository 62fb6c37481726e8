// Kernel B4: the TU residual pipeline of 64x64 CTUs.
//
// Replaces hevcasm_tpu/kernels/residual_pallas.py residual_pipeline_ctu
// (_kernel -> residual_core).  Per CTU, against its prediction, with TU x TU
// transform units (TU in {4, 8, 16, 32}, the DST-VII at TU = 4 when asked):
// forward transform, quantize, per-TU nnz, dequantize, inverse transform,
// add and clip (residual_core<TU, DST> of residual_core.cuh, the stage K2
// and B3 run at TU = 8).
//
// What bounds it on the H100: per CTU 4 passes of 4096 * TU
// multiply-adds (0.5 M at TU = 32, 67 M for a 510-CTU frame) against 8 KB
// read and 4 KB plus the nnz written, so neither the int32 pipes nor device
// memory are near their limit: at 1080p the bytes alone (6.3 MB) take about
// 2 us.  Latency is the limit: one block runs a CTU's three barrier-separated
// passes (four above 8x8 TUs).  The design keeps the CTU, its prediction and both int32 work
// planes in shared memory (41-43 KB), holds one TU-long row or column a
// thread in registers (46-80 registers, no spills; above 8x8 the column
// pass is split in two so that a thread never holds two columns), and
// reads every matrix entry uniformly across the warp (the constant cache
// broadcasts it).  Four or five blocks share an SM up to 16x16 TUs, so a
// 510-CTU frame runs in one wave; three at 32x32.
//
// The TPU kernel's block-diagonal kron(I, T) matrices and bf16 hi/lo
// splits are a matrix-unit layout device; the integers are the same.

#include "residual_core.cuh"

namespace {

template <int TU, bool DST>
__global__ void __launch_bounds__(NT)
residual_ctu_kernel(const uint8_t* __restrict__ src,
                    const uint8_t* __restrict__ pred,
                    uint8_t* __restrict__ rec, int32_t* __restrict__ nnz_out,
                    int qscale, int qshift, int qoffset, int dscale, int dshift) {
  constexpr int K = B / TU;
  __shared__ __align__(16) uint8_t s_src[B * B];
  __shared__ __align__(16) uint8_t s_pred[B * B];
  __shared__ __align__(16) int s_work[2 * B * B];
  __shared__ int s_nnz[K * K];
  __shared__ int s_bits[K * K];

  const int i = blockIdx.x;
  const int t = threadIdx.x;
  const uint32_t* s4 = reinterpret_cast<const uint32_t*>(src + static_cast<size_t>(i) * B * B);
  const uint32_t* p4 = reinterpret_cast<const uint32_t*>(pred + static_cast<size_t>(i) * B * B);
  for (int k = t; k < B * B / 4; k += NT) {
    reinterpret_cast<uint32_t*>(s_src)[k] = s4[k];
    reinterpret_cast<uint32_t*>(s_pred)[k] = p4[k];
  }
  __syncthreads();
  residual_core<TU, DST>(s_src, s_pred, s_work, s_nnz, s_bits,
                         rec + static_cast<size_t>(i) * B * B,
                         nnz_out + static_cast<size_t>(i) * K * K, nullptr,
                         qscale, qshift, qoffset, dscale, dshift);
}

template <int TU, bool DST>
cudaError_t launch(const uint8_t* src, const uint8_t* pred, uint8_t* rec, int32_t* nnz,
                   int n, int qscale, int qshift, int qoffset, int dscale, int dshift,
                   cudaStream_t stream) {
  residual_ctu_kernel<TU, DST><<<n, NT, 0, stream>>>(src, pred, rec, nnz, qscale, qshift,
                                                     qoffset, dscale, dshift);
  return cudaGetLastError();
}

}  // namespace

// src, pred (n, 64, 64) uint8 contiguous; rec (n, 64, 64) uint8; nnz
// (n, 64/tu, 64/tu) int32.  tu in {4, 8, 16, 32}; tr_type 1 (DST-VII) only
// at tu = 4.  The caller checks the quantizer ranges (1 <= qscale < 2^15,
// 16 <= qshift <= 27, 0 <= qoffset < 2^15, 1 <= dshift <= 31).  Launches on
// `stream`, returns cudaGetLastError().
extern "C" int hevc_residual_ctu(const uint8_t* src, const uint8_t* pred, uint8_t* rec,
                                 int32_t* nnz, int n, int tu, int tr_type, int qscale,
                                 int qshift, int qoffset, int dscale, int dshift,
                                 int device, void* stream) {
  if (qshift < 16 || qshift > 27 || dshift < 1 || dshift > 31 || (tr_type && tu != 4))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n == 0) return cudaGetLastError();
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tu) {
    case 4:
      return tr_type ? launch<4, true>(src, pred, rec, nnz, n, qscale, qshift, qoffset, dscale, dshift, s)
                     : launch<4, false>(src, pred, rec, nnz, n, qscale, qshift, qoffset, dscale, dshift, s);
    case 8: return launch<8, false>(src, pred, rec, nnz, n, qscale, qshift, qoffset, dscale, dshift, s);
    case 16: return launch<16, false>(src, pred, rec, nnz, n, qscale, qshift, qoffset, dscale, dshift, s);
    case 32: return launch<32, false>(src, pred, rec, nnz, n, qscale, qshift, qoffset, dscale, dshift, s);
    default: return cudaErrorInvalidValue;
  }
}
