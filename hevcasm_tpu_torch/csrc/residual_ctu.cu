// Kernel B4: the TU residual pipeline of 64x64 CTUs.
//
// Replaces hevcasm_tpu/kernels/residual_pallas.py residual_pipeline_ctu
// (_kernel -> residual_core).  Per CTU, against its prediction, with TU x TU
// transform units (TU in {4, 8, 16, 32}, the DST-VII at TU = 4 when asked):
// forward transform, quantize, per-TU nnz, dequantize, inverse transform,
// add and clip (residual_tile<TU, DST> of residual_core.cuh, the stage K2,
// B3 and B19 run at TU = 8).
//
// What bounds it on the H100: per CTU 8 KB read and 4 KB plus the nnz
// written (6.4 MB for a 510-CTU frame, ~0.002 ms at 3.35 TB/s) against 4
// passes of 4096 * TU multiply-adds (0.5 M a CTU at TU = 32, 267 M for the
// frame, ~0.3 us on the int8 tensor cores), so the bytes; the design's own floor is
// its mma.sync products (2 a pass and n tile, 16 m16n8k16 a 16x16 tile,
// 64 m16n8k32 a 32x32 one) and the quantizer's CUDA-core instructions.
// The design: a warp codes one W x W tile (W = 16, or 32 at TU = 32) with
// the four passes chained in its registers (residual_core.cuh), reading
// its source and prediction words straight from device memory and
// writing its pixels and nnz there: no shared memory and no barrier, so
// 8 independent tiles a 256-thread block (half a CTU, or two CTUs at TU
// = 32).
//
// The TPU kernel's block-diagonal kron(I, T) matrices and bf16 hi/lo
// splits become the s8 bands of mma.sync and the s8/u8 byte split of the
// int16 intermediates; the integers are the same.

#include "residual_core.cuh"

namespace {

template <int TU, bool DST>
__global__ void __launch_bounds__(NT)
residual_ctu_kernel(const uint8_t* __restrict__ src,
                    const uint8_t* __restrict__ pred,
                    uint8_t* __restrict__ rec, int32_t* __restrict__ nnz_out, int n,
                    QParams qp) {
  using S = restc::Tile<TU, DST>;
  constexpr int K = B / TU;
  constexpr int PER_CTU = S::SIDE * S::SIDE;
  const int w = blockIdx.x * (NT / 32) + (threadIdx.x >> 5);
  const int i = w / PER_CTU, tile = w - i * PER_CTU;
  if (i >= n) return;
  const size_t ctu = static_cast<size_t>(i) * B * B;
  residual_tile<TU, DST>(src + ctu, pred + ctu, rec + ctu,
                         nnz_out + static_cast<size_t>(i) * K * K, nullptr, tile / S::SIDE,
                         tile % S::SIDE, qp);
}

template <int TU, bool DST>
cudaError_t launch(const uint8_t* src, const uint8_t* pred, uint8_t* rec, int32_t* nnz,
                   int n, const QParams& qp, cudaStream_t stream) {
  using S = restc::Tile<TU, DST>;
  constexpr int TILES_PER_BLOCK = NT / 32;
  const long long tiles = static_cast<long long>(n) * S::SIDE * S::SIDE;
  const int blocks = static_cast<int>((tiles + TILES_PER_BLOCK - 1) / TILES_PER_BLOCK);
  residual_ctu_kernel<TU, DST><<<blocks, NT, 0, stream>>>(src, pred, rec, nnz, n, qp);
  return cudaGetLastError();
}

}  // namespace

// src, pred (n, 64, 64) uint8 contiguous, 4-byte aligned; rec (n, 64, 64)
// uint8; nnz (n, 64/tu, 64/tu) int32.  tu in {4, 8, 16, 32}; tr_type 1
// (DST-VII) only at tu = 4.  The caller checks the quantizer ranges (1 <=
// qscale < 2^15, 16 <= qshift <= 27, 0 <= qoffset < 2^15, 1 <= dshift <=
// 31).  Launches on `stream`, returns cudaGetLastError().
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
  const QParams qp = {qscale, qshift, qoffset, dscale, dshift};
  switch (tu) {
    case 4:
      return tr_type ? launch<4, true>(src, pred, rec, nnz, n, qp, s)
                     : launch<4, false>(src, pred, rec, nnz, n, qp, s);
    case 8: return launch<8, false>(src, pred, rec, nnz, n, qp, s);
    case 16: return launch<16, false>(src, pred, rec, nnz, n, qp, s);
    case 32: return launch<32, false>(src, pred, rec, nnz, n, qp, s);
    default: return cudaErrorInvalidValue;
  }
}
