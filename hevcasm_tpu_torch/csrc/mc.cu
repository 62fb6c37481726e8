// Kernels B5 and B6: uni- and bi-prediction of blocks at given fractions.
//
// Replace hevcasm_tpu/kernels/mc_pallas.py pred_uni_pallas[_batched] (body
// _uni_kernel) and pred_bi_pallas[_batched] (body _bi_kernel).  For block i
// of h x w pixels and its window of at least (h + T - 1) x (w + T - 1)
// bytes, T = 8 (luma quarter-pel, KERNEL8, fractions 0-3) or T = 4 (chroma
// eighth-pel, KERNEL4, fractions 0-7), at the block's (xf, yf):
//
//   H pass:  p[r][x]  = wrap16(sum_t KH[xf][t] * win[r][x + t])
//   V pass:  acc[y][x] = sum_t KV[yf][t] * p[y + t][x]
//   uni:     out = clip((acc + 2048) >> 12, 0, 255)
//   bi:      r_k = wrap16(acc_k >> 6) for each window, then
//            out = clip((r_0 + r_1 + 64) >> 7, 0, 255)
//
// as ops.pred_inter.pred_uni / pred_bi do.  No encode path calls them: they
// are the KERNEL tiers of the registry's pred_uni and pred_bi, which the
// self-test sweeps (64x64 to 4x2 blocks, both tap families).
//
// What bounds it on the H100: the bytes.  510 64x64 luma blocks move 2.6 MB
// of windows in and 2.1 MB out (1.4 us at 3.35 TB/s; bi-prediction 7.2 MB,
// 2.1 us) for 35 M multiply-adds (bi 70 M), which the int8 tensor cores
// would take in 0.04 us.  The TPU kernel's banded FIR
// matrices and hi/lo byte split serve its matrix unit; here each thread
// sums the taps itself.
//
// Design: one block of threads per pixel block, the H/V pass structure of
// refine_core.cuh at the block's one fraction: the window is staged in
// shared memory (rows any number of bytes apart in device memory, no
// alignment assumed, so widths of 7, 11, 19, 35 and 71 bytes are read as
// they lie), the horizontal pass writes an int16 plane of (h + T - 1) x w,
// the vertical pass reads it.  Bi-prediction runs the two paths in turn
// and keeps the first path's int16 result in shared memory.  A fraction
// comes from a per-block int32 array on the device or, with a null
// pointer, from one value for every block; it is taken modulo the phase
// count (4 or 8), the wrapper's host check having ruled out other ints.

#include "refine_core.cuh"

namespace {

// HEVC chroma eighth-pel filters, KERNEL4[frac][tap].
__constant__ int K4[8][4] = {
    {0, 64, 0, 0},
    {-2, 58, 10, -2},
    {-4, 54, 16, -2},
    {-6, 46, 28, -4},
    {-4, 36, 36, -4},
    {-4, 28, 46, -6},
    {-2, 16, 54, -4},
    {-2, 10, 58, -2},
};

// The most shared memory a block may opt in to on sm_90 (227 KB).
constexpr size_t MC_MAX_SMEM = 232448;

// One fraction: per block from `ptr` when it is not null, else `value`.
struct Frac {
  const int32_t* ptr;
  int value;
  __device__ int at(int i, int phases) const { return (ptr ? ptr[i] : value) & (phases - 1); }
};

// One window operand: block i's window at base + i * stride, rows `row`
// bytes apart.
struct Win {
  const uint8_t* base;
  long long stride;
  long long row;
};

template <int T>
__device__ __forceinline__ int tap(int frac, int t) {
  if constexpr (T == 8) return K8[frac][t];
  else return K4[frac][t];
}

// Stage block i's window in s_win ((h + T - 1) rows of (w + T - 1) bytes)
// and write its int16 horizontal pass at fraction xf to s_h ((h + T - 1)
// rows of w); ends on a barrier, so s_h is then visible to every thread.
template <int T>
__device__ __forceinline__ void h_pass(const Win& win, int i, int xf, int h, int w,
                                       uint8_t* s_win, int16_t* s_h) {
  const int ww = w + T - 1, rows = h + T - 1;
  const uint8_t* src = win.base + i * win.stride;
  for (int k = threadIdx.x; k < rows * ww; k += blockDim.x) {
    const int r = k / ww, c = k - r * ww;
    s_win[k] = src[r * win.row + c];
  }
  __syncthreads();
  for (int k = threadIdx.x; k < rows * w; k += blockDim.x) {
    const int r = k / w, c = k - r * w;
    const uint8_t* p = s_win + r * ww + c;
    int v = 0;
#pragma unroll
    for (int t = 0; t < T; ++t) v += tap<T>(xf, t) * p[t];
    s_h[k] = static_cast<int16_t>(wrap16(v));
  }
  __syncthreads();
}

// The pre-shift vertical accumulator of pixel (y, x) at fraction yf.
template <int T>
__device__ __forceinline__ int v_acc(const int16_t* s_h, int yf, int w, int y, int x) {
  int acc = 0;
#pragma unroll
  for (int t = 0; t < T; ++t) acc += tap<T>(yf, t) * s_h[(y + t) * w + x];
  return acc;
}

// Shared bytes of one block: the staged window, the int16 horizontal pass
// and, for bi-prediction, the first path's int16 result.
__host__ __device__ inline size_t smem_bytes(int taps, bool bi, int h, int w) {
  const size_t rows = h + taps - 1;
  const size_t win = (rows * (w + taps - 1) + 1) & ~size_t(1);
  return win + 2 * rows * w + (bi ? 2 * size_t(h) * w : 0);
}

template <int T, bool BI>
__global__ void __launch_bounds__(256)
pred_kernel(Win w0, Frac xf0, Frac yf0, Win w1, Frac xf1, Frac yf1, uint8_t* __restrict__ out,
            int h, int w) {
  extern __shared__ __align__(16) uint8_t smem[];
  constexpr int PH = T == 8 ? 4 : 8;
  const int rows = h + T - 1;
  const size_t win_bytes = (static_cast<size_t>(rows) * (w + T - 1) + 1) & ~size_t(1);
  uint8_t* s_win = smem;
  int16_t* s_h = reinterpret_cast<int16_t*>(smem + win_bytes);
  int16_t* s_r0 = s_h + rows * w;
  const int i = blockIdx.x;
  uint8_t* o = out + static_cast<size_t>(i) * h * w;

  h_pass<T>(w0, i, xf0.at(i, PH), h, w, s_win, s_h);
  const int yf = yf0.at(i, PH);
  for (int k = threadIdx.x; k < h * w; k += blockDim.x) {
    const int y = k / w, x = k - y * w;
    const int acc = v_acc<T>(s_h, yf, w, y, x);
    if constexpr (BI) s_r0[k] = static_cast<int16_t>(wrap16(acc >> 6));
    else o[k] = static_cast<uint8_t>(clip3(0, 255, (acc + 2048) >> 12));
  }
  if constexpr (BI) {
    __syncthreads();                                   // s_win and s_h reused
    h_pass<T>(w1, i, xf1.at(i, PH), h, w, s_win, s_h);
    const int yf1v = yf1.at(i, PH);
    for (int k = threadIdx.x; k < h * w; k += blockDim.x) {
      const int y = k / w, x = k - y * w;
      const int r1 = wrap16(v_acc<T>(s_h, yf1v, w, y, x) >> 6);
      o[k] = static_cast<uint8_t>(clip3(0, 255, (s_r0[k] + r1 + 64) >> 7));
    }
  }
}

template <int T, bool BI>
cudaError_t launch(Win w0, Frac xf0, Frac yf0, Win w1, Frac xf1, Frac yf1, uint8_t* out,
                   int n, int h, int w, cudaStream_t stream) {
  const size_t smem = smem_bytes(T, BI, h, w);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(pred_kernel<T, BI>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int threads = h * w >= 1024 ? 256 : 64;
  pred_kernel<T, BI><<<n, threads, smem, stream>>>(w0, xf0, yf0, w1, xf1, yf1, out, h, w);
  return cudaGetLastError();
}

cudaError_t dispatch(bool bi, int taps, Win w0, Frac xf0, Frac yf0, Win w1, Frac xf1,
                     Frac yf1, uint8_t* out, int n, int h, int w, int device, void* stream) {
  if (n < 0 || h < 1 || w < 1 || (taps != 8 && taps != 4)
      || smem_bytes(taps, bi, h, w) > MC_MAX_SMEM)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n == 0) return cudaGetLastError();
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bi) return taps == 8 ? launch<8, true>(w0, xf0, yf0, w1, xf1, yf1, out, n, h, w, s)
                           : launch<4, true>(w0, xf0, yf0, w1, xf1, yf1, out, n, h, w, s);
  return taps == 8 ? launch<8, false>(w0, xf0, yf0, w1, xf1, yf1, out, n, h, w, s)
                   : launch<4, false>(w0, xf0, yf0, w1, xf1, yf1, out, n, h, w, s);
}

}  // namespace

// windows: block i's window at windows + i * win_stride, rows win_row bytes
// apart, at least (h + taps - 1) x (w + taps - 1); xfrac / yfrac (n,) int32
// on the device, or null to take xval / yval for every block; out (n, h, w)
// uint8 contiguous.  taps 8 or 4.  Launches on `stream` and returns
// cudaGetLastError() (cudaErrorInvalidValue for a shape it does not take).
extern "C" int hevc_pred_uni(const uint8_t* windows, long long win_stride, long long win_row,
                             const int32_t* xfrac, const int32_t* yfrac, int xval, int yval,
                             uint8_t* out, int n, int h, int w, int taps, int device,
                             void* stream) {
  const Win w0{windows, win_stride, win_row};
  return dispatch(false, taps, w0, Frac{xfrac, xval}, Frac{yfrac, yval}, w0,
                  Frac{xfrac, xval}, Frac{yfrac, yval}, out, n, h, w, device, stream);
}

// Bi-prediction: two windows as in hevc_pred_uni, and the fractions of each
// (fracs[0..3] = xfrac0, yfrac0, xfrac1, yfrac1, each (n,) int32 or null,
// then vals[0..3] in the same order).
extern "C" int hevc_pred_bi(const uint8_t* windows0, long long win0_stride,
                            long long win0_row, const uint8_t* windows1,
                            long long win1_stride, long long win1_row,
                            const int32_t* xfrac0, const int32_t* yfrac0,
                            const int32_t* xfrac1, const int32_t* yfrac1, int xval0,
                            int yval0, int xval1, int yval1, uint8_t* out, int n, int h,
                            int w, int taps, int device, void* stream) {
  return dispatch(true, taps, Win{windows0, win0_stride, win0_row}, Frac{xfrac0, xval0},
                  Frac{yfrac0, yval0}, Win{windows1, win1_stride, win1_row},
                  Frac{xfrac1, xval1}, Frac{yfrac1, yval1}, out, n, h, w, device, stream);
}
