// Kernels B5 and B6 (mc.cu) on the u8/s8 tensor cores: the two FIR passes
// of uni- and bi-prediction at one fraction a block, as mma.sync products.
// For block i of h x w pixels, its window of (h + T - 1) x (w + T - 1)
// bytes, T = 8 (KERNEL8, fractions 0-3) or 4 (KERNEL4, fractions 0-7):
//
//   H pass:  p[r][x]   = wrap16(sum_t KH[xf][t] * win[r][x + t])
//   V pass:  acc[y][x] = sum_t KV[yf][t] * p[y + t][x]
//   uni:     out = clip((acc + 2048) >> 12, 0, 255)
//   bi:      r_k = wrap16(acc_k >> 6) for each window, then
//            out = clip((r_0 + r_1 + 64) >> 7, 0, 255)
//
// A warp owns a strip of 16 output columns and a run of SPW steps of 16
// output rows; its fractions are uniform, so each filter is one band of
// lane words built once:
//
//   1. the CTA stages its block's windows in shared memory by 16-byte
//      cp.async, all in flight at once: each row's bytes as the aligned
//      16-byte chunks of device memory that hold them (rows may lie any
//      number of bytes apart, so a row starts 0-15 bytes into its first
//      chunk), rows WS bytes apart (WS = 16 x an odd number, so the 8 rows
//      x 4 words of a B fragment hit 32 banks); a B word is then two shared
//      words from the row's offset, funnel-shifted by its last 2 bits.
//      Only the window's chunks are written: whatever else the products
//      read meets zero taps or feeds columns past the block.  The block's
//      fractions are fetched first and its bands built while the windows
//      are in flight;
//   2. horizontal pass, m16n8k32 .s8.u8, per chunk c of 16 window rows: A =
//      the xf band (16 output columns, in step 4's order, x 32 window bytes
//      of the strip), B = the bytes of rows 16c + g (product P) and 16c + 8
//      + g (Q).  Lane (g, t) then holds its columns m = g and g + 8 of rows
//      16c + 2t, + 1 (P) and 16c + 8 + 2t, + 1 (Q): four rows of one column,
//      which byte permutes turn into the vertical pass's B words of the
//      int16 intermediate's hi (s8) and lo (u8) bytes, with no store and no
//      shuffle;
//   3. vertical pass, m16n8k32, A = the yf band (16 output rows x the 32
//      intermediate rows of chunks q and q + 1, in the order the lanes hold
//      them), B = those words of 8 columns: acc = 256 (hi band) + lo band
//      (.s8.s8, then .s8.u8), for the two 8-column halves of the strip;
//      chunk q + 1 serves step q + 1 as chunk q;
//   4. the epilogue in the accumulator registers: the horizontal band's
//      rows are the strip's columns in the order strip_column gives, so
//      lane (g, t) holds output rows g and g + 8, columns 4t .. 4t + 3 of
//      both halves, stored as one word a row (bytes where w is no multiple
//      of 4).  Bi-prediction runs both windows' products on the same tile
//      in the same layout and combines them in registers.
//
// A CTA codes one block: CTAs shared by several small blocks (every 32x32
// chroma block among them) measured slower on the H100.

#pragma once

#include <cstddef>
#include <cstdint>

// The C entries' packed argument block (kernels/mc.py _ARGS: 25 int64),
// outside the unnamed namespace so that the entries that take it keep
// external linkage.  Window stack k: block i's window at win[k] + i *
// win_stride[k], rows win_row[k] bytes apart.  Fractions xf0, yf0, xf1,
// yf1: block i's is frac[j][i * frac_stride[j]] (device int32) or, where
// frac[j] is 0, val[j].
struct McArgs {
  long long win[2], win_stride[2], win_row[2];
  long long frac[4], frac_stride[4], val[4];
  long long out, n, h, w, taps, device, stream;
};

namespace {
namespace mctc {

constexpr int MAX_WARPS = 8;          // warps a CTA
constexpr int SPW = 4;                // steps of 16 output rows a warp
constexpr int MIN_CTAS = 1;           // __launch_bounds__'s CTAs an SM
constexpr long long MAX_SMEM = 232448;   // the shared memory a CTA may opt in to

__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }

// The tiling of a call, the same on the host and the device.
struct Geom {
  int h, w, paths;
  int strips;     // 16-column strips
  int steps;      // steps of 16 output rows
  int tasks;      // warp tasks: strips x runs of up to SPW steps
  int ws;         // staged row stride: 16 x odd >= 16 strips + 32
  int win_bytes;  // one staged window: chunks 0 .. steps of 16 rows
  int warps;      // warps a CTA
  long long smem; // bytes a CTA
};

__host__ __device__ inline Geom geometry(int h, int w, int paths) {
  Geom g{};
  g.h = h;
  g.w = w;
  g.paths = paths;
  g.strips = (w + 15) / 16;
  g.steps = (h + 15) / 16;
  g.tasks = g.strips * ((g.steps + SPW - 1) / SPW);
  g.ws = 16 * ((g.strips + 2) | 1);
  const long long win = 16LL * (g.steps + 1) * g.ws;
  g.win_bytes = win > MAX_SMEM ? 0 : static_cast<int>(win);
  g.warps = imin(g.tasks, MAX_WARPS);
  g.smem = paths * win;
  return g;
}

#define MCTC_PTX
// d += a (16x32 s8, row) * b (32x8 u8 or s8, col), s32.
__device__ __forceinline__ void mma_s8u8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_s8s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The 16 bytes at src (device memory, 16-aligned) to dst (shared,
// 16-aligned), in flight until cp_async_wait_all.
__device__ __forceinline__ void cp_async16(uint8_t* dst, const uint8_t* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(static_cast<unsigned>(__cvta_generic_to_shared(dst))), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
#undef MCTC_PTX

// KERNEL8[f] (T = 8) or KERNEL4[f] (T = 4) as signed bytes, tap 0 in the
// low byte, 0 past the last tap.
template <int T>
__device__ __forceinline__ uint64_t filter_bytes(int f) {
  if constexpr (T == 8) {
    return f == 0 ? 0x0000000040000000ull
         : f == 1 ? 0x0001FB113AF604FFull
         : f == 2 ? 0xFF04F52828F504FFull
                  : 0xFF04F63A11FB0100ull;
  } else {
    return f == 0 ? 0x00004000ull
         : f == 1 ? 0xFE0A3AFEull
         : f == 2 ? 0xFE1036FCull
         : f == 3 ? 0xFC1C2EFAull
         : f == 4 ? 0xFC2424FCull
         : f == 5 ? 0xFA2E1CFCull
         : f == 6 ? 0xFC3610FEull
                  : 0xFE3A0AFEull;
  }
}

// Taps first .. first + 3 as one word of s8 bytes, 0 outside 0..7.
__device__ __forceinline__ uint32_t band_word(uint64_t taps, int first) {
  if (first >= 8 || first <= -4) return 0u;
  return first >= 0 ? static_cast<uint32_t>(taps >> (8 * first))
                    : static_cast<uint32_t>(taps << (-8 * first));
}

// Taps first and first + 1 in the word's two low bytes.
__device__ __forceinline__ uint32_t band_pair(uint64_t taps, int first) {
  return band_word(taps, first) & 0xFFFFu;
}

// The strip column of row m of the horizontal products' A (and so of B
// column m & 7 of the vertical products of half m >> 3): 4 ((m >> 1) & 3) + 2
// (m >> 3) + (m & 1), so that lane t's accumulators of both halves hold
// columns 4t .. 4t + 3 of a row.
__device__ __forceinline__ int strip_column(int m) {
  return 4 * ((m >> 1) & 3) + 2 * (m >> 3) + (m & 1);
}

// A lane's A fragments: h, the horizontal band (A[m][c] = KH[c -
// strip_column(m)], strip byte c); v, the vertical band (A[m][k] = KV[row(k)
// - m], output row m, k the position of intermediate row row(k) = 16 (k >>
// 4) + 2 ((k >> 2) & 3) + (k & 1) + 8 ((k >> 1) & 1), the order of step
// 2's words).  Register r of lane (g, t) holds A[g + 8 (r & 1)][16 (r >>
// 1) + 4t ..  + 3].
struct Bands {
  uint32_t h[4], v[4];
};

template <int T>
__device__ __forceinline__ Bands bands(int xf, int yf) {
  const uint64_t x = filter_bytes<T>(xf), y = filter_bytes<T>(yf);
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int c0 = 4 * t - strip_column(g), c1 = 4 * t - strip_column(g + 8), e = 2 * t - g;
  Bands b;
  b.h[0] = band_word(x, c0);
  b.h[1] = band_word(x, c1);
  b.h[2] = band_word(x, c0 + 16);
  b.h[3] = band_word(x, c1 + 16);
  b.v[0] = band_pair(y, e) | band_pair(y, e + 8) << 16;
  b.v[1] = band_pair(y, e - 8) | band_pair(y, e) << 16;
  b.v[2] = 0u;                                  // rows 16 + ... - g >= 9
  b.v[3] = band_pair(y, e + 8);                 // its upper pair at e + 16
  return b;
}

__device__ __forceinline__ uint32_t lds32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A staged window: its rows in shared memory from s, WS bytes apart; row r
// starts offset(r) = (base + r * step) & 15 bytes into its first chunk.
struct Staged {
  const uint8_t* s;
  unsigned base, step;
  __device__ __forceinline__ unsigned offset(int r) const { return (base + r * step) & 15; }
};

// Step 1 for one window (rows x width bytes, rows `row` bytes apart from
// src in device memory) by the CTA's nthreads threads: chunk q of row r is
// the aligned 16 bytes at the row's start rounded down + 16q, for q < qw
// and while it holds a byte of the row (no read leaves the aligned chunks
// that hold the row); thread k takes chunks k, k + nthreads, ... in row
// order, the row and chunk advancing by (dr, dq), so only the start
// divides.
__device__ __forceinline__ void stage_window(const uint8_t* __restrict__ src, long long row,
                                             int rows, int width, int nthreads, uint8_t* win,
                                             int ws) {
  const int qw = (width + 15) / 16 + 1, dr = nthreads / qw, dq = nthreads - dr * qw;
  const uintptr_t a0 = reinterpret_cast<uintptr_t>(src);
  int r = threadIdx.x / qw, q = threadIdx.x - r * qw;
  while (r < rows) {
    const uintptr_t a = a0 + r * row;
    if (16 * q < static_cast<int>(a & 15) + width)
      cp_async16(win + r * ws + 16 * q,
                 reinterpret_cast<const uint8_t*>((a & ~uintptr_t(15)) + 16 * q));
    q += dq;
    r += dr;
    if (q >= qw) {
      q -= qw;
      ++r;
    }
  }
}

// Step 2: chunk c of strip s, the intermediate's B words for the vertical
// pass: lo[G] and hi[G] hold rows 16c + 2t, + 1, 16c + 8 + 2t, + 1 of column
// 16 s + 8 G + g (the low and the high byte of each int16).  The products'
// B words are bytes 16 s + 4t .. + 3 and 16 s + 16 + 4t .. + 3 of window
// rows 16c + g and 16c + 8 + g.
struct Chunk {
  uint32_t lo[2], hi[2];
};

__device__ __forceinline__ Chunk h_chunk(const Staged& w, int ws, int s, int c,
                                         const uint32_t (&a)[4]) {
  const int lane = threadIdx.x & 31, r = 16 * c + (lane >> 2);
  const uint8_t* p0 = w.s + r * ws + 16 * s + 4 * (lane & 3);
  int d0[4] = {0, 0, 0, 0}, d1[4] = {0, 0, 0, 0};
  unsigned o = w.offset(r), sh = 8 * (o & 3);
  const uint8_t* p = p0 + (o & 12);
  mma_s8u8(d0, a, __funnelshift_r(lds32(p), lds32(p + 4), sh),
           __funnelshift_r(lds32(p + 16), lds32(p + 20), sh));
  o = w.offset(r + 8);
  sh = 8 * (o & 3);
  p = p0 + 8 * ws + (o & 12);
  mma_s8u8(d1, a, __funnelshift_r(lds32(p), lds32(p + 4), sh),
           __funnelshift_r(lds32(p + 16), lds32(p + 20), sh));
  Chunk k;
#pragma unroll
  for (int G = 0; G < 2; ++G) {
    const uint32_t x0 = __byte_perm(static_cast<uint32_t>(d0[2 * G]),
                                    static_cast<uint32_t>(d0[2 * G + 1]), 0x5140);
    const uint32_t x1 = __byte_perm(static_cast<uint32_t>(d1[2 * G]),
                                    static_cast<uint32_t>(d1[2 * G + 1]), 0x5140);
    k.lo[G] = __byte_perm(x0, x1, 0x5410);
    k.hi[G] = __byte_perm(x0, x1, 0x7632);
  }
  return k;
}

// Step 3: d = c + acc for the 16 output rows of a step and the 8 columns
// of half G, from chunks q (k0) and q + 1 (k1); c rides the hi product at
// 1/256 of its weight.
__device__ __forceinline__ void v_acc(int (&d)[4], const uint32_t (&a)[4], const Chunk& k0,
                                      const Chunk& k1, int G) {
  mma_s8s8(d, a, k0.hi[G], k1.hi[G]);
#pragma unroll
  for (int j = 0; j < 4; ++j) d[j] *= 256;
  mma_s8u8(d, a, k0.lo[G], k1.lo[G]);
}

__device__ __forceinline__ int clip255(int v) { return v < 0 ? 0 : v > 255 ? 255 : v; }

__device__ __forceinline__ int wrap16(int v) {
  return static_cast<int>(static_cast<int16_t>(static_cast<uint16_t>(v)));
}

// Step 4's store: lane (g, t)'s bytes of row y0 + g, columns x0 + 4t ..
// + 3, are v0[0], v0[1], v1[0], v1[1] (the two halves' accumulators), and
// of row y0 + g + 8 v0[2], v0[3], v1[2], v1[3]; a word a row where w is a
// multiple of 4, else bytes; nothing past the h x w block at o.
__device__ __forceinline__ void store_rows(uint8_t* o, int h, int w, int y0, int x0,
                                           const int (&v0)[4], const int (&v1)[4]) {
  const int lane = threadIdx.x & 31, x = x0 + 4 * (lane & 3);
  if (x >= w) return;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int y = y0 + (lane >> 2) + 8 * half;
    if (y >= h) return;
    uint8_t* p = o + static_cast<size_t>(y) * w + x;
    const int r = 2 * half;
    if (!(w & 3)) {
      *reinterpret_cast<uint32_t*>(p) = static_cast<uint32_t>(
          v0[r] | v0[r + 1] << 8 | v1[r] << 16 | v1[r + 1] << 24);
    } else {
      const int b[4] = {v0[r], v0[r + 1], v1[r], v1[r + 1]};
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (x + k < w) p[k] = static_cast<uint8_t>(b[k]);
    }
  }
}

// Steps 2-4 of one warp task: strip s, steps q0 .. q1 - 1 (q1 - q0 <= SPW),
// windows w0 (and w1) staged, bands b0 (and b1), output block o.
template <bool BI>
__device__ __forceinline__ void strip_task(const Geom& g, const Staged& w0, const Staged& w1,
                                           int s, int q0, int q1, const Bands& b0,
                                           const Bands& b1, uint8_t* o) {
  Chunk k0 = h_chunk(w0, g.ws, s, q0, b0.h), m0{};
  if constexpr (BI) m0 = h_chunk(w1, g.ws, s, q0, b1.h);
#pragma unroll
  for (int j = 0; j < SPW; ++j) {
    const int q = q0 + j;
    if (q >= q1) break;
    const Chunk k1 = h_chunk(w0, g.ws, s, q + 1, b0.h);
    Chunk m1{};
    if constexpr (BI) m1 = h_chunk(w1, g.ws, s, q + 1, b1.h);
    int v[2][4];
#pragma unroll
    for (int G = 0; G < 2; ++G) {
      int d[4] = {BI ? 0 : 8, BI ? 0 : 8, BI ? 0 : 8, BI ? 0 : 8};
      v_acc(d, b0.v, k0, k1, G);
      if constexpr (BI) {
        int e[4] = {0, 0, 0, 0};
        v_acc(e, b1.v, m0, m1, G);
#pragma unroll
        for (int r = 0; r < 4; ++r)
          v[G][r] = clip255((wrap16(d[r] >> 6) + wrap16(e[r] >> 6) + 64) >> 7);
      } else {
#pragma unroll
        for (int r = 0; r < 4; ++r) v[G][r] = clip255(d[r] >> 12);
      }
    }
    store_rows(o, g.h, g.w, 16 * q, 16 * s, v[0], v[1]);
    k0 = k1;
    m0 = m1;
  }
}

// Block i's fractions (xf0, yf0 and, for bi-prediction, xf1, yf1), modulo
// the phase count.
template <int PHASES, bool BI>
__device__ __forceinline__ void fractions(const McArgs& a, long long i, int (&f)[4]) {
#pragma unroll
  for (int j = 0; j < (BI ? 4 : 2); ++j) {
    const int32_t* p = reinterpret_cast<const int32_t*>(a.frac[j]);
    f[j] = (p ? __ldg(p + i * a.frac_stride[j]) : static_cast<int>(a.val[j])) & (PHASES - 1);
  }
}

// CTA i (block i) of nthreads threads (a multiple of 32): its fractions
// fetched and step 1 issued, its bands built while the windows are in
// flight, one barrier, then each warp takes tasks warp, warp + warps, ...
// in (run, strip) order.  smem holds g.smem bytes.
template <int T, bool BI>
__device__ __forceinline__ void run_cta(const McArgs& a, const Geom& g, long long i, int nthreads,
                                        uint8_t* smem) {
  constexpr int PHASES = T == 8 ? 4 : 8;
  int f[4];
  fractions<PHASES, BI>(a, i, f);
#pragma unroll
  for (int p = 0; p < (BI ? 2 : 1); ++p)
    stage_window(reinterpret_cast<const uint8_t*>(a.win[p]) + i * a.win_stride[p], a.win_row[p],
                 g.h + T - 1, g.w + T - 1, nthreads, smem + p * g.win_bytes, g.ws);
  const Bands b0 = bands<T>(f[0], f[1]);
  Bands b1{};
  if constexpr (BI) b1 = bands<T>(f[2], f[3]);
  const Staged w0{smem, static_cast<unsigned>((a.win[0] + i * a.win_stride[0]) & 15),
                  static_cast<unsigned>(a.win_row[0] & 15)};
  const Staged w1{smem + g.win_bytes, static_cast<unsigned>((a.win[1] + i * a.win_stride[1]) & 15),
                  static_cast<unsigned>(a.win_row[1] & 15)};
  uint8_t* o = reinterpret_cast<uint8_t*>(a.out) + static_cast<size_t>(i) * g.h * g.w;
  cp_async_wait_all();
  __syncthreads();
  for (int k = threadIdx.x >> 5; k < g.tasks; k += nthreads >> 5) {
    const int run = k / g.strips, s = k - run * g.strips;
    const int q0 = run * SPW, q1 = imin(q0 + SPW, g.steps);
    strip_task<BI>(g, w0, w1, s, q0, q1, b0, b1, o);
  }
}

}  // namespace mctc
}  // namespace
