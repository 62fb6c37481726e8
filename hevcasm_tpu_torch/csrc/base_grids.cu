// Kernels B14 and B15: the sub-block SSD grids of every CTU, and the per-PU
// first minimum over them.
//
// Replace hevcasm_tpu/kernels/search_pallas.py base_grids_ctu and
// base_layout_decide (both _base_grids_kernel).  For CTU i, sub-block (p, q)
// of side BASE in {8, 16, 32} (k = 64 / BASE per side) and displacement
// (dy, dx) in [0, 2R]^2 of its (64 + 2R)^2 search window:
//
//   grid[i][p][q][dy][dx] = sum_{y,x < BASE} (win[i][BASE*p + dy + y][BASE*q + dx + x]
//                                              - src[i][BASE*p + y][BASE*q + x])^2
//
// in exact int32 (a whole CTU sums below 4096 * 255^2 < 2^31).  B14 writes
// the grids, (n, k, k, 2R+1, 2R+1) in [dy, dx] order.  B15 takes a list of
// PUs, each a list of distinct sub-blocks, sums each PU's sub-block grids
// and keeps its first minimum in row-major [dy, dx] order: (n, P, 3) int32
// [dy - R, dx - R, ssd].  R is a runtime argument, 1 <= R <= 32.
//
// What bounds them on the H100: the correlation, (2R+1)^2 * 4096
// multiply-adds per CTU, 8.8 G for a 1920x1088 frame at R = 32; B14 also
// writes its grids, 138 MB a frame at BASE 16 and 552 MB at BASE 8 (0.165
// ms at 3.35 TB/s), which bound it.
//
// B14's design: block (CTU i, m tile) stages the 79 window rows its 16 dy
// rows read, Z and S as B15 does, and E_pq for every sub-block at once: the
// column sums of height BASE of w^2 (a thread a column and half of the
// rows) and their exclusive prefix along each row (a warp a row), so that
// E_pq[dy][dx] is the difference of two prefix entries BASE apart.  Warp w
// keeps one sub-block column q = w mod k and loops over its sub-blocks
// (p, q) (8 of them at BASE 8): C_pq for its m tile and all 9 n tiles on
// mma.sync m16n8k32 u8 (csrc/ssd_tc_core.cuh narrow_products) against the
// band of K1's Z from the 16-aligned column o = BASE q rounded down, BW =
// max(BASE, 16) bytes wide (32 ks - 8 nt in [-24, BW]), each band word
// ANDed with the mask of the sub-block's columns; then S + E - 2C (8-byte
// pairs of E read and written, free of bank conflicts) into the warp's 16 x
// 72 tile in shared memory, and the slab's 16 whole dy rows of 2R + 1 int32
// (4160 contiguous bytes at R = 32) written by the warp, three 4-byte
// stores a row contiguous across it; the padded tile rows and columns
// never leave.  q, o and the mask are the warp's for all its sub-blocks, so one
// code path serves every column (B15's core instead compiles the column
// into the warp's loop: at BASE 8 with one band a block that took 1.07 ms
// a 1080p frame on an H100 at 700 W, against 0.97-1.01 for the CUDA-core
// loop it replaces; its products took 0.66 ms of it, E 0.25).  The block
// syncs three times, and the warps' loops run free of each other.
//
// B15's design: the grids never leave the block, as on the TPU.
//   grid_pq = S_pq + E_pq - 2 C_pq,  C_pq[dy][dx] = sum_{y in band p} A_y B_{y,q},
// with A_y and the Toeplitz band B_y of K1 (csrc/ssd_tc_core.cuh) and
// B_{y,q} the band restricted to source columns [BASE q, BASE q + BASE):
// each lane's band words ANDed with a mask of the bytes whose source column
// lies there.  Block (i, m, group) owns the 16 dy rows of m tile m and NG
// n8 tiles of dx (all 9 at BASE 16 and 32, 2 at BASE 8, whose 64 sub-block
// grids would not fit); warp (q, h) owns sub-block column q and every WPQ-th
// band p from h: it accumulates C_pq on mma.sync m16n8k32 u8 over the BASE
// source rows of the band and writes -2 C_pq into the block's grids in
// shared memory, (k^2, 16, 8 NG) int32.  A (k step, n tile) fragment of
// B_{y,q} is zero unless 32 ks - 8 nt lies in [BASE q - 24, BASE q + BASE];
// q and the block's first n tile are template constants of the warp's loop
// (the block dispatches to it), so the skip rule, the word indices and the
// tile indices are all resolved at compile time, as in K1.  The tensor work
// is ~2x K1's a CTU at BASE 16 (the 16-wide bands leave most of a fragment
// zero), 3.4x at BASE 8.  Then the block adds S_pq (a warp sum of s^2 per
// sub-block) and E_pq (BASE x BASE box sums of w^2: column sums of height
// BASE, a thread a column with its rows in registers, into the shared
// memory that held the source band; their exclusive prefix along each row,
// a warp a row; differences of the prefix BASE apart), and decides: for
// each PU, each thread sums the PU's members at its candidates side by
// side, keeps its first minimum, and two redux.sync minima (the least SSD,
// then the least candidate index holding it) give the warp's, packed as
// (ssd << 32 | dy * (2R+1) + dx): a uint64 whose unsigned minimum is the
// row-major first minimum, so a shared atomicMin per warp and one global
// atomicMin per (CTU, PU, block) combine them; a small kernel decodes the
// keys.  At BASE 16 a block takes 102 KB and 8 warps, two blocks an SM (5
// n tiles a block, 69 KB, three blocks, took 0.49 against 0.41 ms for 510
// CTUs on an H100 at 700 W: staging and S/E repeat per block).

#include <cuda_runtime.h>
#include <stdint.h>

#include "ssd_tc_core.cuh"

namespace {

using hevc_tc::CTU;
using hevc_tc::MAX_R;

// The exclusive prefix of a row of `count` int32 (count <= 32 PER) in
// place, by one warp: entry x becomes the sum of entries 0 .. x - 1, for x
// < count + 1 (the row holds count + 1 entries).
template <int PER>
__device__ __forceinline__ void warp_exclusive_prefix(int32_t* row, int count) {
  const int lane = threadIdx.x & 31;
  int v[PER], sum = 0;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int x = lane * PER + i;
    v[i] = x < count ? row[x] : 0;
    sum += v[i];
  }
  int inc = sum;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_up_sync(0xffffffffu, inc, off);
    if (lane >= off) inc += o;
  }
  int run = inc - sum;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int x = lane * PER + i;
    if (x <= count) row[x] = run;
    run += v[i];
  }
}

// ---- B15 -----------------------------------------------------------------

constexpr int TILE = 16;                                   // dy rows of a block
constexpr int WROWS = TILE + CTU - 1;                      // window rows staged: 79
constexpr int WIN_BYTES = (WROWS * hevc_tc::WS + 15) / 16 * 16;
constexpr unsigned long long NO_KEY = ~0ull;
// Warps a sub-block column: at BASE 16 and 32 two, each taking every other
// band, so that a block has 8 (BASE 16) or 4 warps; at BASE 8 one (8 warps).
template <int BASE>
constexpr int WPQ = BASE == 8 ? 1 : 2;
__host__ __device__ constexpr int block_threads(int base) {
  return 32 * (CTU / base) * (base == 8 ? 1 : 2);
}
static_assert(WIN_BYTES % 16 == 0, "window rows");

// The (k step, n tile) fragment of B_{y,q} is non-zero: 32 ks - 8 nt in
// [BASE q - 24, BASE q + BASE].
template <int BASE>
__host__ __device__ constexpr bool band_meets(int q, int ks, int nt) {
  return 32 * ks - 8 * nt >= BASE * q - 24 && 32 * ks - 8 * nt <= BASE * q + BASE;
}

// Warp (q, half)'s products: C_pq for the block's 16 dy rows and n tiles
// NT0 .. NT0 + NG - 1, for bands p = half, half + WPQ, ..., each written as
// -2 C_pq to s_val.
template <int BASE, int NG, int Q, int NT0>
__device__ __forceinline__ void band_products(const uint8_t* s_win, const uint2* s_z,
                                              int32_t* s_val, int half, int ks_count,
                                              int nt_count) {
  using namespace hevc_tc;
  constexpr int K = CTU / BASE;
  constexpr int VW = 8 * NG;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const BandLane bl = band_lane(lane);
  // Word i holds source columns -8 + 8i + 4t - g + b, b = 0..3; keep the
  // bytes of sub-block column Q.
  uint32_t mask[BAND_WORDS];
#pragma unroll
  for (int i = 0; i < BAND_WORDS; ++i) {
    mask[i] = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int c = -8 + 8 * i + 4 * t - g + b;
      if (c >= BASE * Q && c < BASE * Q + BASE) mask[i] |= 0xFFu << (8 * b);
    }
  }
  const uint8_t* a_lane = s_win + (lane & 15) * WS + 16 * (lane >> 4);
  for (int p = half; p < K; p += WPQ<BASE>) {
    int acc[NG][4];
#pragma unroll
    for (int n = 0; n < NG; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[n][i] = 0;
    uint2 zn[BAND_WORDS];
#pragma unroll
    for (int i = 0; i < BAND_WORDS; ++i) zn[i] = s_z[p * BASE * ZW + bl.zq + 2 * i];
#pragma unroll 2
    for (int yy = 0; yy < BASE; ++yy) {
      const int y = p * BASE + yy;
      uint32_t wd[BAND_WORDS];
#pragma unroll
      for (int i = 0; i < BAND_WORDS; ++i) wd[i] = band_word(zn[i], bl.zsh) & mask[i];
      if (yy + 1 < BASE) {
        const uint2* zr = s_z + (y + 1) * ZW + bl.zq;
#pragma unroll
        for (int i = 0; i < BAND_WORDS; ++i) zn[i] = zr[2 * i];
      }
      const uint8_t* ar = a_lane + y * WS;
#pragma unroll
      for (int ks = 0; ks < MAX_KS; ++ks) {
        bool any = false;
#pragma unroll
        for (int n = 0; n < NG; ++n) any |= NT0 + n < MAX_NT && band_meets<BASE>(Q, ks, NT0 + n);
        if (!any || ks >= ks_count) continue;
        uint32_t a[4];
        ldmatrix_x4(a, ar + 32 * ks);
#pragma unroll
        for (int n = 0; n < NG; ++n) {
          const int nt = NT0 + n;
          if (nt >= MAX_NT || !band_meets<BASE>(Q, ks, nt)) continue;
          if (nt >= nt_count) break;
          const int d = 32 * ks - 8 * nt;
          const uint32_t b0 = d >= -8 ? wd[(d + 8) / 8] : 0u;
          const uint32_t b1 = d + 16 <= 64 ? wd[(d + 24) / 8] : 0u;
          mma_u8(acc[n], a, b0, b1);
        }
      }
    }
    int32_t* v = s_val + (p * K + Q) * TILE * VW;
#pragma unroll
    for (int n = 0; n < NG; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        v[(g + 8 * (i >> 1)) * VW + 8 * n + 2 * t + (i & 1)] = -2 * acc[n][i];
  }
}

// Runs band_products for the warp's (q, nt0), both known only at run time,
// with them as template constants.
template <int BASE, int NG, int Q = 0, int NT0 = 0>
__device__ __forceinline__ void dispatch_products(int q, int nt0, const uint8_t* s_win,
                                                  const uint2* s_z, int32_t* s_val, int half,
                                                  int ks_count, int nt_count) {
  if constexpr (Q < CTU / BASE) {
    if constexpr (NT0 < hevc_tc::MAX_NT) {
      if (q == Q && nt0 == NT0) {
        band_products<BASE, NG, Q, NT0>(s_win, s_z, s_val, half, ks_count, nt_count);
        return;
      }
      dispatch_products<BASE, NG, Q, NT0 + NG>(q, nt0, s_win, s_z, s_val, half, ks_count,
                                               nt_count);
    } else {
      dispatch_products<BASE, NG, Q + 1, 0>(q, nt0, s_win, s_z, s_val, half, ks_count,
                                            nt_count);
    }
  }
}

__host__ __device__ constexpr int val_bytes(int k, int ng) { return k * k * TILE * 8 * ng * 4; }

// Block (CTU i, m tile, n-tile group), 32 k WPQ threads.  pu_table:
// offsets (num_pu + 1), then the sub-block indices of every PU, table_len
// ints in all.  keys (n, num_pu) uint64, ~0 before the launch.  Dynamic
// shared memory: the window rows, s_z, the grids, the keys, S, the table.
template <int BASE, int NG>
__global__ void __launch_bounds__(block_threads(BASE))
decide_kernel(const uint8_t* __restrict__ src, const uint8_t* __restrict__ windows,
              int ctu_stride, int row_stride, const int32_t* __restrict__ pu_table,
              int num_pu, int table_len, int radius, unsigned long long* __restrict__ keys) {
  using namespace hevc_tc;
  constexpr int K = CTU / BASE;
  constexpr int THREADS = block_threads(BASE);
  constexpr int WARPS = THREADS / 32;
  constexpr int VW = 8 * NG;                    // dx columns of the block
  constexpr int CAND = TILE * VW;               // candidates of the block
  constexpr int CW = VW + CTU - 1;              // columns of the column sums
  constexpr int CSS = CW + 1;                   // their row stride, and the prefix's length
  constexpr int PER = (CSS + 31) / 32;          // prefix entries a lane
  constexpr int CPT = (CAND + THREADS - 1) / THREADS;
  static_assert(TILE * CSS * 4 <= Z_BYTES, "column sums fit where s_z was");
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* s_win = smem;
  uint2* s_z = reinterpret_cast<uint2*>(smem + WIN_BYTES);
  int32_t* s_cs = reinterpret_cast<int32_t*>(smem + WIN_BYTES);       // after the products
  int32_t* s_val = reinterpret_cast<int32_t*>(smem + WIN_BYTES + Z_BYTES);
  unsigned long long* s_key = reinterpret_cast<unsigned long long*>(
      smem + WIN_BYTES + Z_BYTES + val_bytes(K, NG));
  int32_t* s_sum = reinterpret_cast<int32_t*>(s_key + num_pu);       // S, k^2
  int32_t* s_tab = s_sum + K * K;

  const int num = 2 * radius + 1, wide = CTU + 2 * radius;
  const int ks_count = (wide + 31) / 32, nt_count = (num + 7) / 8;
  const int ctu = blockIdx.x, dy0 = TILE * blockIdx.y, nt0 = NG * blockIdx.z;
  const int dxg0 = 8 * nt0;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // The CTU's words into the grid buffer (free until the products end),
  // the table, the keys, and the window rows dy0 .. dy0 + 78, WS bytes
  // each; bytes past the window are 0 (they feed only dy or dx >= 2R + 1).
  uint32_t* staged = reinterpret_cast<uint32_t*>(s_val);
  const uint8_t* s = src + static_cast<size_t>(ctu) * CTU * CTU;
  for (int i = tid; i < CTU * CTU / 4; i += THREADS) staged[i] = load_word(s + 4 * i);
  for (int i = tid; i < num_pu; i += THREADS) s_key[i] = NO_KEY;
  for (int i = tid; i < table_len; i += THREADS) s_tab[i] = pu_table[i];
  const uint8_t* w = windows + static_cast<size_t>(ctu) * ctu_stride;
  for (int i = tid; i < WROWS * (WS / 4); i += THREADS) {
    const int r = i / (WS / 4), x = 4 * (i - r * (WS / 4));
    uint32_t v = 0;
    if (dy0 + r < wide && x < wide) {
      const uint8_t* rp = w + static_cast<size_t>(dy0 + r) * row_stride + x;
      if (x + 4 <= wide) {
        v = load_word(rp);
      } else {
        for (int b = 0; b < wide - x; ++b) v |= static_cast<uint32_t>(rp[b]) << (8 * b);
      }
    }
    reinterpret_cast<uint32_t*>(s_win)[i] = v;
  }
  __syncthreads();
  stage_z(staged, s_z);
  // S: a warp a sub-block.
  for (int pq = warp; pq < K * K; pq += WARPS) {
    const int p = pq / K, q = pq % K;
    int acc = 0;
    for (int i = lane; i < BASE * BASE / 4; i += 32) {
      const int y = p * BASE + i / (BASE / 4), x = q * (BASE / 4) + i % (BASE / 4);
      acc += sq_bytes(staged[y * (CTU / 4) + x]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) s_sum[pq] = acc;
  }
  __syncthreads();

  dispatch_products<BASE, NG>(warp % K, nt0, s_win, s_z, s_val, warp / K, ks_count, nt_count);
  __syncthreads();

  // + S_pq + E_pq, band by band: column sums of height BASE of w^2 over
  // the staged rows (a thread a column, its rows in registers), their
  // exclusive prefix along each row (a warp a row), then differences of
  // the prefix BASE apart.
  for (int p = 0; p < K; ++p) {
    for (int x = tid; x < CW; x += THREADS) {
      const uint8_t* col = s_win + BASE * p * WS + dxg0 + x;
      int sq[BASE + TILE - 1];
#pragma unroll
      for (int i = 0; i < BASE + TILE - 1; ++i) {
        const int a = col[i * WS];
        sq[i] = a * a;
      }
      int cs = 0;
#pragma unroll
      for (int i = 0; i < BASE; ++i) cs += sq[i];
      s_cs[x] = cs;
#pragma unroll
      for (int r = 1; r < TILE; ++r) {
        cs += sq[r + BASE - 1] - sq[r - 1];
        s_cs[r * CSS + x] = cs;
      }
    }
    __syncthreads();
    for (int r = warp; r < TILE; r += WARPS) warp_exclusive_prefix<PER>(s_cs + r * CSS, CW);
    __syncthreads();
    for (int item = tid; item < K * CAND; item += THREADS) {
      const int q = item / CAND, c = item - q * CAND;
      const int r = c / VW, dx = c - r * VW;
      const int32_t* pre = s_cs + r * CSS + BASE * q + dx;
      s_val[(p * K + q) * CAND + c] += s_sum[p * K + q] + pre[BASE] - pre[0];
    }
    __syncthreads();
  }

  // The decision: each PU's first minimum over the block's candidates, a
  // thread's CPT candidates summed side by side.
  const int rows_valid = min(TILE, num - dy0);
  int cand[CPT];
#pragma unroll
  for (int i = 0; i < CPT; ++i) {
    const int c = tid + i * THREADS;
    const int r = c / VW, dx = dxg0 + c - r * VW;
    cand[i] = (c < CAND && r < rows_valid && dx < num) ? (dy0 + r) * num + dx : -1;
  }
  const int32_t* members = s_tab + num_pu + 1;
  for (int pu = 0; pu < num_pu; ++pu) {
    const int m0 = s_tab[pu], m1 = s_tab[pu + 1];
    int v[CPT];
#pragma unroll
    for (int i = 0; i < CPT; ++i) v[i] = 0;
#pragma unroll 4
    for (int m = m0; m < m1; ++m) {
      const int32_t* grid = s_val + members[m] * CAND + tid;
#pragma unroll
      for (int i = 0; i < CPT; ++i)
        if (CAND % THREADS == 0 || tid + i * THREADS < CAND) v[i] += grid[i * THREADS];
    }
    // The thread's candidates run in row-major order, so a strict < keeps
    // its first minimum; the warp's is the least index among the lanes
    // holding the least SSD (every SSD is below 2^31, so ~0 means none).
    uint32_t best = ~0u, at = ~0u;
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      if (cand[i] >= 0 && static_cast<uint32_t>(v[i]) < best) {
        best = static_cast<uint32_t>(v[i]);
        at = static_cast<uint32_t>(cand[i]);
      }
    }
    const uint32_t warp_best = __reduce_min_sync(0xffffffffu, best);
    const uint32_t warp_at = __reduce_min_sync(0xffffffffu, best == warp_best ? at : ~0u);
    if (lane == 0 && warp_best != ~0u)
      atomicMin(&s_key[pu], (static_cast<unsigned long long>(warp_best) << 32) | warp_at);
  }
  __syncthreads();
  for (int pu = tid; pu < num_pu; pu += THREADS)
    if (s_key[pu] != NO_KEY) atomicMin(&keys[static_cast<size_t>(ctu) * num_pu + pu], s_key[pu]);
}

template <int BASE, int NG>
cudaError_t launch_decide(int n, int radius, cudaStream_t stream, const uint8_t* src,
                          const uint8_t* windows, int ctu_stride, int row_stride,
                          const int32_t* pu_table, int num_pu, int table_len,
                          unsigned long long* keys) {
  constexpr int K = CTU / BASE;
  const int num = 2 * radius + 1;
  const int mt = (num + 15) / 16, groups = ((num + 7) / 8 + NG - 1) / NG;
  const size_t smem = WIN_BYTES + hevc_tc::Z_BYTES + val_bytes(K, NG)
                      + static_cast<size_t>(num_pu) * 8 + K * K * 4
                      + static_cast<size_t>(table_len) * 4;
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  auto kernel = decide_kernel<BASE, NG>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<dim3(n, mt, groups), block_threads(BASE), smem, stream>>>(
      src, windows, ctu_stride, row_stride, pu_table, num_pu, table_len, radius, keys);
  return cudaGetLastError();
}

__global__ void decode_keys_kernel(const unsigned long long* __restrict__ keys,
                                   int32_t* __restrict__ out, int count, int num,
                                   int radius) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  const unsigned long long key = keys[i];
  const int idx = static_cast<int>(key & 0xFFFFFFFFull);
  out[3 * i] = idx / num - radius;
  out[3 * i + 1] = idx % num - radius;
  out[3 * i + 2] = static_cast<int>(key >> 32);
}

// ---- B14 -----------------------------------------------------------------

template <int BASE>
struct B14Geometry {
  static constexpr int K = CTU / BASE;
  static constexpr int WARPS = K * K < 8 ? K * K : 8;       // warp w keeps column w % k
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int BW = BASE < 16 ? 16 : BASE;         // the band, from a 16-aligned column
  static constexpr int NB = BW / 8 + 2;                    // band words a lane
  static constexpr int KS = 3;                             // k steps: 2R + BW <= 96 columns
  static constexpr int ROWS = TILE + CTU - 1;              // window rows staged
  static constexpr int WIN = (ROWS * hevc_tc::WS + 15) / 16 * 16;
  static constexpr int EROWS = TILE + CTU - BASE;          // E rows: BASE p + dy, dy < 16
  // E's rows: the prefix of 128 column sums (129 entries), 136 apart, so
  // that the epilogue's 8-byte loads (lane (g, t): row g, column 2t) hit
  // every bank once a half-warp.
  static constexpr int ES = 2 * CTU + 8;
  static constexpr int EBYTES = (EROWS * ES * 4 + 15) / 16 * 16;
  static constexpr int TW = 8 * hevc_tc::MAX_NT;           // a warp's tile: 16 x 72 int32
  static constexpr int OUT = WARPS * TILE * TW * 4;
  static constexpr int BYTES = WIN + hevc_tc::Z_BYTES + EBYTES + OUT + K * K * 4;
  static_assert(WARPS % K == 0, "a warp keeps one sub-block column");
  static_assert(32 * KS >= hevc_tc::MAX_NUM + BW - 1, "the band's k steps");
  static_assert(hevc_tc::MAX_NUM <= 96, "a row of the slab is three warp stores");
  static_assert(CTU * CTU <= OUT, "the source is staged in the warps' tiles");
  static_assert(ES % 32 == 8 && TW % 2 == 0 && BASE % 2 == 0, "8-byte pairs in E and tiles");
};

// Block (CTU i, m tile): grids[i][p][q][dy][dx] for the tile's dy rows.
template <int BASE>
__global__ void __launch_bounds__(B14Geometry<BASE>::THREADS)
base_grids_kernel(const uint8_t* __restrict__ src, const uint8_t* __restrict__ windows,
                  int ctu_stride, int row_stride, int radius, int32_t* __restrict__ grids) {
  using namespace hevc_tc;
  using G = B14Geometry<BASE>;
  constexpr int K = G::K, THREADS = G::THREADS, WARPS = G::WARPS, TW = G::TW, ES = G::ES;
  constexpr int STAGE = 8;                                 // window words a thread loads at once
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* s_win = smem;
  uint2* s_z = reinterpret_cast<uint2*>(smem + G::WIN);
  int32_t* s_e = reinterpret_cast<int32_t*>(smem + G::WIN + Z_BYTES);
  int32_t* s_out = reinterpret_cast<int32_t*>(smem + G::WIN + Z_BYTES + G::EBYTES);
  int32_t* s_sum = reinterpret_cast<int32_t*>(smem + G::WIN + Z_BYTES + G::EBYTES + G::OUT);

  const int num = 2 * radius + 1, wide = CTU + 2 * radius;
  const int ks_count = (num + G::BW - 1 + 31) / 32, nt_count = (num + 7) / 8;
  const int ctu = blockIdx.x, dy0 = TILE * blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // The CTU's words into the warps' tiles (free until the products end) and
  // the window rows dy0 .. dy0 + 78, WS bytes each; bytes past the window
  // are 0 (they feed only dy or dx >= 2R + 1).
  uint32_t* staged = reinterpret_cast<uint32_t*>(s_out);
  const uint8_t* s = src + static_cast<size_t>(ctu) * CTU * CTU;
  for (int i = tid; i < CTU * CTU / 4; i += THREADS) staged[i] = load_word(s + 4 * i);
  const uint8_t* w = windows + static_cast<size_t>(ctu) * ctu_stride;
  for (int i0 = tid; i0 < G::ROWS * (WS / 4); i0 += STAGE * THREADS) {
    uint32_t v[STAGE];
#pragma unroll
    for (int u = 0; u < STAGE; ++u) {
      const int i = i0 + u * THREADS;
      const int r = i / (WS / 4), x = 4 * (i - r * (WS / 4));
      v[u] = 0;
      if (i < G::ROWS * (WS / 4) && dy0 + r < wide && x < wide) {
        const uint8_t* rp = w + static_cast<size_t>(dy0 + r) * row_stride + x;
        if (x + 4 <= wide) {
          v[u] = load_word(rp);
        } else {
          for (int b = 0; b < wide - x; ++b) v[u] |= static_cast<uint32_t>(rp[b]) << (8 * b);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < STAGE; ++u) {
      const int i = i0 + u * THREADS;
      if (i < G::ROWS * (WS / 4)) reinterpret_cast<uint32_t*>(s_win)[i] = v[u];
    }
  }
  __syncthreads();
  // Z and S (a warp a sub-block); E's column sums, a thread a column and a
  // run of rows: cs[r][c] = sum_{y < BASE} w[r + y][c]^2.
  stage_z(staged, s_z);
  for (int pq = warp; pq < K * K; pq += WARPS) {
    const int p = pq / K, q = pq % K;
    int acc = 0;
    for (int i = lane; i < BASE * BASE / 4; i += 32) {
      const int y = p * BASE + i / (BASE / 4), x = q * (BASE / 4) + i % (BASE / 4);
      acc += sq_bytes(staged[y * (CTU / 4) + x]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) s_sum[pq] = acc;
  }
  constexpr int SEGS = THREADS / (2 * CTU) > 1 ? THREADS / (2 * CTU) : 1;
  constexpr int SEG = (G::EROWS + SEGS - 1) / SEGS;
  for (int item = tid; item < 2 * CTU * SEGS; item += THREADS) {
    const int c = item % (2 * CTU), r0 = item / (2 * CTU) * SEG;
    const int r1 = r0 + SEG < G::EROWS ? r0 + SEG : G::EROWS;
    const uint8_t* col = s_win + c;
    int cs = 0;
#pragma unroll
    for (int y = 0; y < BASE; ++y) {
      const int v = col[(r0 + y) * WS];
      cs += v * v;
    }
    s_e[r0 * ES + c] = cs;
    for (int r = r0 + 1; r < r1; ++r) {
      const int a = col[(r + BASE - 1) * WS], b = col[(r - 1) * WS];
      cs += a * a - b * b;
      s_e[r * ES + c] = cs;
    }
  }
  __syncthreads();
  for (int r = warp; r < G::EROWS; r += WARPS) warp_exclusive_prefix<5>(s_e + r * ES, 2 * CTU);
  __syncthreads();

  // The warp's sub-blocks (p, q), q = warp % k: the band from column o, its
  // bytes of the sub-block's columns [lo, lo + BASE) kept.
  const int q = warp % K, o = BASE * q / 16 * 16, lo = BASE * q - o;
  const int g = lane >> 2, t = lane & 3;
  uint32_t mask[G::NB];
#pragma unroll
  for (int i = 0; i < G::NB; ++i) {
    mask[i] = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int c = -8 + 8 * i + 4 * t - g + b;
      if (c >= lo && c < lo + BASE) mask[i] |= 0xFFu << (8 * b);
    }
  }
  const BandLane bl = band_lane(lane);
  const uint8_t* a_lane = s_win + (lane & 15) * WS + 16 * (lane >> 4) + o;
  const uint2* z_lane = s_z + bl.zq + 2 * (o / 8);
  int32_t* tile = s_out + warp * TILE * TW;
  const int rows = min(TILE, num - dy0);
  for (int pq = warp; pq < K * K; pq += WARPS) {
    const int p = pq / K;
    int acc[MAX_NT][4];
    narrow_products<G::BW, BASE, G::KS, WS, ZW, true>(
        acc, a_lane + BASE * p * WS, z_lane + BASE * p * ZW, bl.zsh, mask, ks_count, nt_count);
    // S + E - 2C at the candidates, two a lane at once: accumulators 2h and
    // 2h + 1 of n tile nt hold dy = dy0 + g + 8h, dx = 8 nt + 2t and dx + 1
    // (the tiles' padded rows and columns are dropped; a pair's second
    // column, past the last candidate, is written and never copied); E_pq
    // is the difference of the prefix of row BASE p + dy - dy0 at BASE q +
    // dx + BASE and at BASE q + dx.
    const int s_pq = s_sum[pq];
    const int32_t* e = s_e + BASE * p * ES + BASE * q;
#pragma unroll
    for (int nt = 0; nt < MAX_NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = g + 8 * h, dx = 8 * nt + 2 * t;
        if (r < rows && dx < num) {
          const int2 e0 = *reinterpret_cast<const int2*>(e + r * ES + dx);
          const int2 e1 = *reinterpret_cast<const int2*>(e + r * ES + dx + BASE);
          *reinterpret_cast<int2*>(tile + r * TW + dx) =
              make_int2(s_pq + e1.x - e0.x - 2 * acc[nt][2 * h],
                        s_pq + e1.y - e0.y - 2 * acc[nt][2 * h + 1]);
        }
      }
    __syncwarp();
    int32_t* out = grids + ((static_cast<size_t>(ctu) * K * K + pq) * num + dy0) * num;
#pragma unroll 4
    for (int r = 0; r < rows; ++r)
#pragma unroll
      for (int k = 0; k < 3; ++k)
        if (lane + 32 * k < num) out[r * num + lane + 32 * k] = tile[r * TW + lane + 32 * k];
    __syncwarp();
  }
}

template <int BASE>
cudaError_t launch_grids(int n, int radius, cudaStream_t stream, const uint8_t* src,
                         const uint8_t* windows, int ctu_stride, int row_stride,
                         int32_t* grids) {
  using G = B14Geometry<BASE>;
  const int mt = (2 * radius + 1 + 15) / 16;
  auto kernel = base_grids_kernel<BASE>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         G::BYTES);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(n, mt), G::THREADS, G::BYTES, stream>>>(src, windows, ctu_stride, row_stride,
                                                       radius, grids);
  return cudaGetLastError();
}

}  // namespace

// B14.  src (n, 64, 64) uint8 contiguous; windows: CTU i's (64 + 2R)^2
// window at windows + i * ctu_stride, rows row_stride bytes apart; grids
// (n, k, k, 2R+1, 2R+1) int32.  Launches on `stream` and returns
// cudaGetLastError().
extern "C" int hevc_base_grids(const uint8_t* src, const uint8_t* windows, int ctu_stride,
                               int row_stride, int32_t* grids, int n, int base, int radius,
                               int device, void* stream) {
  if (radius < 1 || radius > MAX_R) return cudaErrorInvalidValue;
  if (base != 8 && base != 16 && base != 32) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n == 0) return cudaGetLastError();
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (base) {
    case 8: return launch_grids<8>(n, radius, s, src, windows, ctu_stride, row_stride, grids);
    case 16: return launch_grids<16>(n, radius, s, src, windows, ctu_stride, row_stride, grids);
    default: return launch_grids<32>(n, radius, s, src, windows, ctu_stride, row_stride, grids);
  }
}

// B15.  src and windows as for B14; pu_table int32 [offsets (num_pu + 1),
// sub-block indices], table_len ints; keys (n, num_pu) uint64 scratch; out
// (n, num_pu, 3) int32 [dy - R, dx - R, ssd].  Three operations on
// `stream`: the keys are set to ~0, the decide kernel keeps each PU's
// minimum, the decode kernel writes out.
extern "C" int hevc_base_decide(const uint8_t* src, const uint8_t* windows, int ctu_stride,
                                int row_stride, const int32_t* pu_table, int num_pu,
                                int table_len, unsigned long long* keys, int32_t* out, int n,
                                int base, int radius, int device, void* stream) {
  if (radius < 1 || radius > MAX_R || num_pu < 1 || table_len < num_pu + 2)
    return cudaErrorInvalidValue;
  if (base != 8 && base != 16 && base != 32) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n == 0) return cudaGetLastError();
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int num = 2 * radius + 1;
  const size_t count = static_cast<size_t>(n) * num_pu;
  err = cudaMemsetAsync(keys, 0xFF, count * sizeof(unsigned long long), s);
  if (err != cudaSuccess) return err;
  switch (base) {
    case 8:
      err = launch_decide<8, 2>(n, radius, s, src, windows, ctu_stride, row_stride, pu_table,
                                num_pu, table_len, keys);
      break;
    case 16:
      err = launch_decide<16, 9>(n, radius, s, src, windows, ctu_stride, row_stride, pu_table,
                                 num_pu, table_len, keys);
      break;
    default:
      err = launch_decide<32, 9>(n, radius, s, src, windows, ctu_stride, row_stride, pu_table,
                                 num_pu, table_len, keys);
  }
  if (err != cudaSuccess) return err;
  decode_keys_kernel<<<static_cast<unsigned>((count + 255) / 256), 256, 0, s>>>(
      keys, out, static_cast<int>(count), num, radius);
  return cudaGetLastError();
}
