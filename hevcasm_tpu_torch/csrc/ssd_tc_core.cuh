// The u8 tensor-core core of the exact SSD grids, shared by K1/B7
// (csrc/ssd_grid_plane.cu), B17 (csrc/search_mv.cu), B19 (csrc/mega.cu) and,
// for its fragments, B14/B15 (csrc/base_grids.cu) and B8 (csrc/ssd_grid.cu);
// B9 (csrc/sad_grid.cu) takes its load_word.
//
// For a 64x64 source block s and a window w, the correlation of the SSD
//
//   C[dy][dx] = sum_{y < 64} sum_j A_y[dy][j] B_y[j][dx],
//   A_y[dy][j] = w[y + dy][j],  B_y[j][dx] = s[y][j - dx] (0 outside 0..63)
//
// runs on mma.sync m16n8k32 u8 x u8 -> s32 (exact: the operands are
// unsigned, so no centring).  A_y is the staged window read in place by
// ldmatrix at a row offset (rows WS bytes apart: a multiple of 16 and not
// of 128, so the eight row reads of one ldmatrix hit eight bank groups).
// B_y, the Toeplitz band of source row y, depends on j - dx only: lane
// (g = lane / 4, t = lane % 4) holds, for the fragment at k step ks and n
// tile nt with d = 32 ks - 8 nt, the bytes OFF + d + 4t - g .. + 3 of Z_y
// (b0) and 16 bytes further (b1), where Z_y is source row y zero-padded
// to 128 bytes with s[y][0] at byte OFF.  Over the d a kernel uses, those
// are the lane's 10 words i = 0..9 at d = -8 + 8i: each the pair s_z[y][zq
// + 2i] shifted right by zsh bits (band_word), so a source row costs a lane
// ten 8-byte shared loads and ten funnel shifts.  A (k step, n tile)
// fragment is zero, and its product skipped, unless its band meets the
// source columns a kernel sums: K1, B17 and B19 all 64 (d in [-24, 64]),
// B15 one sub-block column.
//
// Narrow bands (narrow_products, after the whole-CTU search): B8
// (csrc/ssd_grid.cu) and B14 (csrc/base_grids.cu) multiply one m16 tile of
// dy at a time against a band BW bytes wide whose first column is 16-byte
// aligned in the staged window: B8's b x b block (BW = b, Z_y narrow: s[y]
// at byte 16 of b / 4 + 8 word pairs, band_lane<16>), and B14's sub-block
// (BW = max(BASE, 16), K1's Z at a word offset, each word ANDed with the
// mask of the sub-block's columns).  A lane needs BW / 8 + 2 band words, and
// a fragment is skipped unless 32 ks - 8 nt lies in [-24, BW].
//
// The whole-CTU search (second half of this file) is the block-level form
// that K1/B7, B17 and B19 share: the source staged once (stage_source:
// its words, S = sum s^2 and Z), the window staged with rows WS bytes apart
// (stage_window), the products of warp m < MT for dy rows 16m .. 16m + 15
// and all NT n tiles (tc_products), and E[dy][dx] = sum w[dy + y][dx + x]^2
// for a band of dy rows (window_energy).  Each kernel supplies its epilogue
// through for_each_candidate, which hands it S + E - 2C's parts for the
// candidates (dy, dx) < 2R + 1 only: K1/B7 write the grid, B17 and B19 keep
// the first minimum as a packed key (ssd_key, block_min_key).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace hevc_tc {

constexpr int CTU = 64;
constexpr int MAX_R = 32;
constexpr int MAX_NUM = 2 * MAX_R + 1;               // 65
constexpr int MAX_MT = (MAX_NUM + 15) / 16;          // 5 m16 tiles of dy
constexpr int MAX_NT = (MAX_NUM + 7) / 8;            // 9 n8 tiles of dx
constexpr int MAX_KS = (CTU + 2 * MAX_R + 31) / 32;  // 4 k32 steps of columns
constexpr int WS = 32 * MAX_KS + 16;                 // 144: window row stride
// The source row y is Z_y, 128 bytes with s[y][x] at byte OFF + x and zeros
// around it; s_z[y][q] holds its words q and q + 1.
constexpr int OFF = 32;
constexpr int ZW = 32;
constexpr int Z_BYTES = CTU * ZW * 8;                // 16384
constexpr int BAND_WORDS = 10;                       // a lane's words of B_y
static_assert(WS % 16 == 0 && WS % 128 != 0, "window row stride");

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], const uint8_t* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

// c += a (16x32 u8, row) * b (32x8 u8, col), s32 accumulate.
__device__ __forceinline__ void mma_u8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four bytes at any address: the aligned words that hold them (each holds a
// byte that is read), joined.
__device__ __forceinline__ uint32_t load_word(const uint8_t* p) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const uint32_t* w = reinterpret_cast<const uint32_t*>(a & ~uintptr_t(3));
  const unsigned sh = static_cast<unsigned>(a & 3) * 8;
  const uint32_t lo = __ldg(w);
  return sh ? __funnelshift_r(lo, __ldg(w + 1), sh) : lo;
}

__device__ __forceinline__ int sq_bytes(uint32_t v) {
  int s = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int b = (v >> (8 * i)) & 0xFF;
    s += b * b;
  }
  return s;
}

// s_z from the source's 1024 words (row-major, 16 a row): Z_y word q is
// source word q - OFF/4 of row y, 0 outside the row.  All threads of the
// block take part; the caller synchronises before and after.
__device__ __forceinline__ void stage_z(const uint32_t* staged, uint2* s_z) {
  for (int i = threadIdx.x; i < CTU * ZW; i += blockDim.x) {
    const int y = i / ZW, q = i - y * ZW - OFF / 4;
    const uint32_t lo = (q >= 0 && q < CTU / 4) ? staged[y * (CTU / 4) + q] : 0u;
    const uint32_t hi = (q + 1 >= 0 && q + 1 < CTU / 4) ? staged[y * (CTU / 4) + q + 1] : 0u;
    s_z[i] = make_uint2(lo, hi);
  }
}

// This lane's place in Z_y: word i of its band words is the pair s_z[y][zq
// + 2i] shifted right by zsh bits.  ZOFF is the byte of Z_y that holds
// s[y][0]: OFF here, 16 in B8's narrow rows (csrc/ssd_grid.cu).
struct BandLane {
  int zq;
  unsigned zsh;
};

template <int ZOFF = OFF>
__device__ __forceinline__ BandLane band_lane(int lane) {
  static_assert(ZOFF % 4 == 0 && ZOFF >= 16, "a lane's first byte is ZOFF - 15");
  const int g = lane >> 2, t = lane & 3;
  return {((ZOFF + 4 * t - g) >> 2) - 2, static_cast<unsigned>((ZOFF + 4 * t - g) & 3) * 8};
}

__device__ __forceinline__ uint32_t band_word(uint2 pair, unsigned zsh) {
  return __funnelshift_r(pair.x, pair.y, zsh);
}

// ---- The whole-CTU search ------------------------------------------------

constexpr int WIN_ROWS = CTU + 2 * MAX_R;            // 128 window rows staged
constexpr int WIN_SMEM = WIN_ROWS * WS;              // 18432 bytes
// E rows of 64 + 2R int32, E_STRIDE apart, so that a warp reading one
// column of rows hits 32 banks; E_HALF dy rows hold the larger of K1's two
// parts (dy 0..31, then 32..2R).
constexpr int E_STRIDE = CTU + 2 * MAX_R + 1;        // 129
constexpr int E_HALF = MAX_NUM - 32;                 // 33
constexpr int STAGE_WORDS = 8;                       // window words a thread loads at once
constexpr unsigned long long NO_SSD_KEY = ~0ull;
// The m16 tiles read window rows up to 63 + 16 MT - 1; the rows past the
// window (at most 15 at R = 32) land in s_z, which follows s_win, and only
// feed dy >= 2R + 1.  Rows wide .. 127 of s_win, which no kernel stages at
// R < 32, likewise feed only dy >= 2R + 1.
static_assert((CTU - 1 + 16 * MAX_MT) * WS <= WIN_SMEM + Z_BYTES, "tile rows past smem");
static_assert(WIN_SMEM % 16 == 0, "window rows");

// A barrier of the whole block, and a named barrier of COUNT threads (whole
// warps), for window_energy's groups.
struct BlockSync {
  __device__ __forceinline__ void operator()() const { __syncthreads(); }
};
template <int ID, int COUNT>
struct NamedSync {
  static_assert(ID > 0 && ID < 16 && COUNT % 32 == 0, "a named barrier of whole warps");
  __device__ __forceinline__ void operator()() const {
    asm volatile("bar.sync %0, %1;\n" ::"r"(ID), "r"(COUNT) : "memory");
  }
};

// The CTU s (64 rows of 64 bytes in device memory): its 1024 words into
// `staged` (shared memory, row-major, 16 a row), s_z from them (stage_z),
// and S = sum s^2, returned to every thread.  All THREADS threads of the
// block take part; s_red holds THREADS / 32 ints.  The caller synchronises
// before it reads s_z.
template <int THREADS>
__device__ __forceinline__ int stage_source(const uint8_t* __restrict__ s, uint32_t* staged,
                                            uint2* s_z, int32_t* s_red) {
  constexpr int WORDS = CTU * CTU / 4;
  constexpr int PER = (WORDS + THREADS - 1) / THREADS;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  uint32_t v[PER];
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int i = tid + u * THREADS;
    v[u] = i < WORDS ? load_word(s + 4 * i) : 0u;
  }
  int sq = 0;
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int i = tid + u * THREADS;
    if (i < WORDS) staged[i] = v[u];
    sq += sq_bytes(v[u]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sq += __shfl_down_sync(0xffffffffu, sq, off);
  if (lane == 0) s_red[warp] = sq;
  __syncthreads();
  stage_z(staged, s_z);
  int s_total = 0;
#pragma unroll
  for (int i = 0; i < THREADS / 32; ++i) s_total += s_red[i];
  return s_total;
}

// The window's `wide` rows of `wide` bytes at w (rows row_stride bytes
// apart) into s_win, rows WS bytes apart, STAGE_WORDS words a thread in
// flight; bytes past the width are 0 (wide is even).  All THREADS threads
// take part; the caller synchronises before the window is read.
template <int THREADS>
__device__ __forceinline__ void stage_window(const uint8_t* __restrict__ w, size_t row_stride,
                                             int wide, uint8_t* s_win) {
  const int tid = threadIdx.x;
  const int words = wide * (WS / 4);
  for (int i0 = tid; i0 < words; i0 += STAGE_WORDS * THREADS) {
    uint32_t v[STAGE_WORDS];
#pragma unroll
    for (int u = 0; u < STAGE_WORDS; ++u) {
      const int i = i0 + u * THREADS;
      const int y = i / (WS / 4), x = 4 * (i - y * (WS / 4));
      v[u] = 0;
      if (i < words && x < wide) {
        const uint8_t* rp = w + static_cast<size_t>(y) * row_stride + x;
        v[u] = x + 4 <= wide ? load_word(rp) : (rp[0] | (static_cast<uint32_t>(rp[1]) << 8));
      }
    }
#pragma unroll
    for (int u = 0; u < STAGE_WORDS; ++u) {
      const int i = i0 + u * THREADS;
      if (i < words) reinterpret_cast<uint32_t*>(s_win)[i] = v[u];
    }
  }
}

// C on the tensor cores for warp `warp`'s dy rows 16 warp .. 16 warp + 15
// and all NT n tiles, into acc (zeroed first; 36 registers at R = 32).  For
// each source row y the lane loads A_y's fragments straight from the
// staged window with ldmatrix (row y + dy: a row offset, no copy) and
// builds B_y's from its 10 band words, loaded a row ahead while row y's
// products run; two rows are unrolled (faster on an H100 than one; issuing
// the k steps out of order was slower).  The fragment of k step ks and n
// tile nt is zero unless 32 ks - 8 nt lies in [-24, 64], and the others
// are skipped: 26 of 36 pairs a warp at R = 32.
__device__ __forceinline__ void tc_products(int (&acc)[MAX_NT][4], const uint8_t* s_win,
                                            const uint2* s_z, int warp, int ks_count,
                                            int nt_count) {
  const int lane = threadIdx.x & 31;
  const BandLane bl = band_lane(lane);
  const int zq = bl.zq;
  const unsigned zsh = bl.zsh;
  const uint8_t* a_lane = s_win + (16 * warp + (lane & 15)) * WS + 16 * (lane >> 4);
#pragma unroll
  for (int nt = 0; nt < MAX_NT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] = 0;
  uint2 zn[BAND_WORDS];
#pragma unroll
  for (int i = 0; i < BAND_WORDS; ++i) zn[i] = s_z[zq + 2 * i];
#pragma unroll 2
  for (int y = 0; y < CTU; ++y) {
    uint32_t wd[BAND_WORDS];
#pragma unroll
    for (int i = 0; i < BAND_WORDS; ++i) wd[i] = band_word(zn[i], zsh);
    if (y + 1 < CTU) {
      const uint2* zr = s_z + (y + 1) * ZW + zq;
#pragma unroll
      for (int i = 0; i < BAND_WORDS; ++i) zn[i] = zr[2 * i];
    }
    const uint8_t* ar = a_lane + y * WS;
#pragma unroll
    for (int ks = 0; ks < MAX_KS; ++ks) {
      if (ks >= ks_count) break;
      uint32_t a[4];
      ldmatrix_x4(a, ar + 32 * ks);
#pragma unroll
      for (int nt = 0; nt < MAX_NT; ++nt) {
        const int d = 32 * ks - 8 * nt;   // j - dx at the tile's corner
        if (d < -24 || d > 64) continue;
        if (nt >= nt_count) break;
        const uint32_t b0 = d >= -8 ? wd[(d + 8) / 8] : 0u;
        const uint32_t b1 = d + 16 <= 64 ? wd[(d + 24) / 8] : 0u;
        mma_u8(acc[nt], a, b0, b1);
      }
    }
  }
}

// E[dy][dx] = sum_{y,x < 64} w[dy + y][dx + x]^2 for dy in [d0, d0 + rows)
// and dx < num, into e (dy's row at e + (dy - d0) * E_STRIDE): column sums
// of squares over 64 rows sliding down dy, then sums of 64 of them sliding
// across dx, in place.  Run by the threads t = 0 .. nth - 1 of a group whose
// barrier is sync(); the caller synchronises before (e free) and after (e
// ready).
template <class Sync>
__device__ __forceinline__ void window_energy(const uint8_t* s_win, int32_t* e, int d0,
                                              int rows, int wide, int num, int t, int nth,
                                              Sync sync) {
  for (int c = t; c < wide; c += nth) {
    int cs = 0;
#pragma unroll 16
    for (int y = 0; y < CTU; ++y) {
      const int v = s_win[(d0 + y) * WS + c];
      cs += v * v;
    }
    e[c] = cs;
#pragma unroll 4
    for (int r = 1; r < rows; ++r) {
      const int a = s_win[(d0 + r + CTU - 1) * WS + c], b = s_win[(d0 + r - 1) * WS + c];
      cs += a * a - b * b;
      e[r * E_STRIDE + c] = cs;
    }
  }
  sync();
  for (int r = t; r < rows; r += nth) {
    int32_t* row = e + r * E_STRIDE;
    int s = 0;
#pragma unroll 16
    for (int x = 0; x < CTU; ++x) s += row[x];
#pragma unroll 4
    for (int dx = 0; dx < num; ++dx) {
      const int old = row[dx];
      row[dx] = s;
      if (dx + 1 < num) s += row[dx + CTU] - old;
    }
  }
}

// f(dy, dx, C[dy][dx]) for each candidate whose correlation this lane holds
// in warp `warp`'s accumulators, dy and dx < num only: accumulator i of n
// tile nt holds dy = 16 warp + g + 8 (i >> 1), dx = 8 nt + 2t + (i & 1).
// The tiles' padded rows and columns are computed and never reach f.
template <class F>
__device__ __forceinline__ void for_each_candidate(const int (&acc)[MAX_NT][4], int warp,
                                                   int num, F f) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < MAX_NT; ++nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int dy = 16 * warp + g + 8 * (i >> 1), dx = 8 * nt + 2 * t + (i & 1);
      if (dy < num && dx < num) f(dy, dx, acc[nt][i]);
    }
  }
}

// The first minimum in row-major [dy, dx] order is the least packed key
// (SSD << 32) | (dy (2R + 1) + dx): the smaller SSD (>= 0), then the smaller
// index.  Keys combine with min() in any order.
__device__ __forceinline__ unsigned long long ssd_key(int ssd, int idx) {
  return (static_cast<unsigned long long>(static_cast<uint32_t>(ssd)) << 32)
         | static_cast<uint32_t>(idx);
}

__device__ __forceinline__ unsigned long long min_key(unsigned long long a,
                                                      unsigned long long b) {
  return a < b ? a : b;
}

// The least key of the block, returned to every thread: shuffles within
// each warp, then one key a warp through s_keys (blockDim.x / 32 of them),
// which every thread reads after the barrier: the caller writes s_keys
// again only after another.
__device__ __forceinline__ unsigned long long block_min_key(unsigned long long key,
                                                            unsigned long long* s_keys) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    key = min_key(key, __shfl_xor_sync(0xffffffffu, key, off));
  if ((threadIdx.x & 31) == 0) s_keys[threadIdx.x >> 5] = key;
  __syncthreads();
  key = s_keys[0];
  for (int w = 1; w < static_cast<int>(blockDim.x >> 5); ++w) key = min_key(key, s_keys[w]);
  return key;
}

// ---- Narrow bands (B8, B14) --------------------------------------------------

// The fragment of k step ks and n tile nt meets a band BW bytes wide: 32 ks
// - 8 nt in [-24, BW] (its rows j and columns dx give j - dx in [d - 7, d +
// 31], which meets [0, BW - 1] iff -31 <= d <= BW + 6, d a multiple of 8).
template <int BW>
__host__ __device__ constexpr bool narrow_meets(int ks, int nt) {
  return 32 * ks - 8 * nt >= -24 && 32 * ks - 8 * nt <= BW;
}

template <int BW>
__host__ __device__ constexpr bool narrow_step(int ks) {
  bool any = false;
  for (int nt = 0; nt < MAX_NT; ++nt) any |= narrow_meets<BW>(ks, nt);
  return any;
}

// C += the products of one m16 tile of dy over ROWS source rows: a_lane is
// this lane's ldmatrix address at source row 0 and k step 0 (window rows
// WSX bytes apart), z_lane its first Z pair of row 0 (Z rows ZWX pairs
// apart): word i of row y is band_word(z_lane[y ZWX + 2i], zsh), ANDed with
// mask[i] when MASKED.  b0 is zero below d = -8 and b1 above d = BW - 16.
// acc is zeroed first; only k steps < ks_count and n tiles < nt_count run.
template <int BW, int ROWS, int KS, int WSX, int ZWX, bool MASKED>
__device__ __forceinline__ void narrow_products(int (&acc)[MAX_NT][4], const uint8_t* a_lane,
                                                const uint2* z_lane, unsigned zsh,
                                                const uint32_t (&mask)[BW / 8 + 2],
                                                int ks_count, int nt_count) {
  constexpr int NB = BW / 8 + 2;
#pragma unroll
  for (int nt = 0; nt < MAX_NT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] = 0;
  uint2 zn[NB];
#pragma unroll
  for (int i = 0; i < NB; ++i) zn[i] = z_lane[2 * i];
#pragma unroll 2
  for (int y = 0; y < ROWS; ++y) {
    uint32_t wd[NB];
#pragma unroll
    for (int i = 0; i < NB; ++i) wd[i] = MASKED ? band_word(zn[i], zsh) & mask[i]
                                                : band_word(zn[i], zsh);
    if (y + 1 < ROWS) {
      const uint2* zr = z_lane + (y + 1) * ZWX;
#pragma unroll
      for (int i = 0; i < NB; ++i) zn[i] = zr[2 * i];
    }
    const uint8_t* ar = a_lane + y * WSX;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      if (!narrow_step<BW>(ks)) continue;
      if (ks >= ks_count) break;
      uint32_t a[4];
      ldmatrix_x4(a, ar + 32 * ks);
#pragma unroll
      for (int nt = 0; nt < MAX_NT; ++nt) {
        if (!narrow_meets<BW>(ks, nt)) continue;
        if (nt >= nt_count) break;
        const int d = 32 * ks - 8 * nt;
        const uint32_t b0 = d >= -8 ? wd[(d + 8) / 8] : 0u;
        const uint32_t b1 = d <= BW - 16 ? wd[(d + 24) / 8] : 0u;
        mma_u8(acc[nt], a, b0, b1);
      }
    }
  }
}

}  // namespace hevc_tc
