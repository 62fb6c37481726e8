// Kernels B5 and B6: uni- and bi-prediction of blocks at given fractions.
//
// Replace hevcasm_tpu/kernels/mc_pallas.py pred_uni_pallas[_batched] (body
// _uni_kernel) and pred_bi_pallas[_batched] (body _bi_kernel), computing
// ops.pred_inter.pred_uni / pred_bi: both FIR passes on the u8/s8 tensor
// cores, as mc_tc.cuh describes.  No encode path calls them: they are the
// KERNEL tiers of the registry's pred_uni and pred_bi, which the self-test
// sweeps (64x64 to 4x2 blocks, both tap families).
//
// What bounds them on the H100.  The work bounds nothing: 510 64x64 luma
// blocks move 2.6 MB of windows in and 2.1 MB out (1.4 us at 3.35 TB/s;
// bi-prediction 7.2 MB, 2.1 us) for 35 M multiply-adds (bi 70 M), which the
// int8 tensor cores take in 0.04 us; one fraction a block makes them 40
// m16n8k32 products of the horizontal pass and 64 of the vertical a 64x64
// block (per window).  A call is bound by latency: the launch of a grid
// that fills the card once, the windows' trip into shared memory, then
// each warp's chain of products, permutes and stores
// (tools/mc_phase_costs.py times each).  So the design keeps that chain
// short: no scalar tap loop, no byte division, the windows in by 16-byte
// cp.async all at once, the intermediate never stored (it goes from the
// horizontal products' accumulators to the vertical products' operands by
// byte permutes), bi-prediction's two paths combined in registers, word
// stores of whole row pieces, one wave of CTAs.  The C entries take one
// packed block of arguments (McArgs), so that a call's host work stays
// small beside the kernel.

#include "mc_tc.cuh"

namespace {

template <int T, bool BI>
__global__ void __launch_bounds__(mctc::MAX_WARPS * 32, mctc::MIN_CTAS)
pred_kernel(const McArgs a, const mctc::Geom g) {
  extern __shared__ __align__(16) uint8_t smem[];
  mctc::run_cta<T, BI>(a, g, blockIdx.x, blockDim.x, smem);
}

template <int T, bool BI>
cudaError_t launch(const McArgs& a, const mctc::Geom& g, cudaStream_t stream) {
  // The opt-in above 48 KB once per instance, device and process (a launch
  // of a smaller or equal size needs no new call).
  static int allowed[64];
  int* mine = a.device < 64 ? &allowed[a.device] : nullptr;
  if (g.smem > 48 * 1024 && (!mine || g.smem > *mine)) {
    const cudaError_t err = cudaFuncSetAttribute(
        pred_kernel<T, BI>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(g.smem));
    if (err != cudaSuccess) return err;
    if (mine) *mine = static_cast<int>(g.smem);
  }
  pred_kernel<T, BI><<<static_cast<unsigned>(a.n), 32 * g.warps, g.smem, stream>>>(a, g);
  return cudaGetLastError();
}

cudaError_t dispatch(const McArgs& a, bool bi) {
  if (a.n < 0 || a.h < 1 || a.w < 1 || (a.taps != 8 && a.taps != 4) || a.h > (1 << 20)
      || a.w > (1 << 20) || a.device < 0 || a.device >= (1LL << 31))
    return cudaErrorInvalidValue;
  const mctc::Geom g = mctc::geometry(static_cast<int>(a.h), static_cast<int>(a.w), bi ? 2 : 1);
  if (g.smem > mctc::MAX_SMEM || a.n >= (1LL << 31))
    return cudaErrorInvalidValue;
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != a.device) err = cudaSetDevice(static_cast<int>(a.device));
  if (err != cudaSuccess) return err;
  if (a.n == 0) return cudaGetLastError();
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(a.stream);
  if (bi) return a.taps == 8 ? launch<8, true>(a, g, s) : launch<4, true>(a, g, s);
  return a.taps == 8 ? launch<8, false>(a, g, s) : launch<4, false>(a, g, s);
}

}  // namespace

// windows: block i's window at win[0] + i * win_stride[0], rows win_row[0]
// bytes apart, at least (h + taps - 1) x (w + taps - 1); fractions xf, yf
// in frac[0..1] (device int32 pointers, block i's at i * frac_stride) or
// val[0..1]; out (n, h, w) uint8 contiguous; taps 8 or 4.  Launches on the
// stream and returns cudaGetLastError() (cudaErrorInvalidValue for a shape
// it does not take).
extern "C" int hevc_pred_uni(const McArgs* args) { return dispatch(*args, false); }

// Bi-prediction: two window stacks (win[0..1]) and the fractions of each
// (frac / val [0..3] = xf0, yf0, xf1, yf1).
extern "C" int hevc_pred_bi(const McArgs* args) { return dispatch(*args, true); }
