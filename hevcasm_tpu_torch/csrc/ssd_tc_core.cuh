// The u8 tensor-core core of the exact SSD grids, shared by K1/B7
// (csrc/ssd_grid_plane.cu) and B15 (csrc/base_grids.cu); B9
// (csrc/sad_grid.cu) takes its load_word.
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
// source columns a kernel sums: K1 all 64 (d in [-24, 64]), B15 one
// sub-block column.

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
// + 2i] shifted right by zsh bits.
struct BandLane {
  int zq;
  unsigned zsh;
};

__device__ __forceinline__ BandLane band_lane(int lane) {
  const int g = lane >> 2, t = lane & 3;
  return {((OFF + 4 * t - g) >> 2) - 2, static_cast<unsigned>((OFF + 4 * t - g) & 3) * 8};
}

__device__ __forceinline__ uint32_t band_word(uint2 pair, unsigned zsh) {
  return __funnelshift_r(pair.x, pair.y, zsh);
}

}  // namespace hevc_tc
