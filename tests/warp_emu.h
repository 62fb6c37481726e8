// One CUDA warp emulated on the CPU, for compiling a device header with a
// host C++20 compiler: each of the 32 lanes is a thread with its own
// threadIdx, and every warp-collective operation (shuffle, __syncwarp, an
// mma.sync product) meets the other lanes at a barrier.  The header's
// mma.sync wrappers are replaced by emu_mma (the test that compiles the
// header does the replacement), which forms the product from the lanes'
// registers with the PTX ISA's fragment layouts of mma.m16n8k16 and
// mma.m16n8k32 with 8-bit integer types.
#pragma once

#include <algorithm>
#include <barrier>
#include <cstdint>

#define __host__
#define __device__
#define __global__
#define __forceinline__ inline
#define __restrict__

struct Dim3 {
  unsigned x, y, z;
};
inline thread_local Dim3 threadIdx;
using std::max;
using std::min;

inline std::barrier<>* g_warp_barrier;
inline uint64_t g_lane_slots[32][16];

inline int emu_lane() { return threadIdx.x & 31; }

inline uint32_t __ldg(const uint32_t* p) { return *p; }

inline uint32_t __byte_perm(uint32_t x, uint32_t y, uint32_t s) {
  const uint64_t v = (static_cast<uint64_t>(y) << 32) | x;
  uint32_t r = 0;
  for (int i = 0; i < 4; ++i)
    r |= static_cast<uint32_t>((v >> (8 * ((s >> (4 * i)) & 7))) & 255) << (8 * i);
  return r;
}

inline int __clz(uint32_t a) { return a ? __builtin_clz(a) : 32; }

template <class T>
T __shfl_xor_sync(unsigned, T v, int offset) {
  g_lane_slots[emu_lane()][0] = static_cast<uint64_t>(v);
  g_warp_barrier->arrive_and_wait();
  const T r = static_cast<T>(g_lane_slots[emu_lane() ^ offset][0]);
  g_warp_barrier->arrive_and_wait();
  return r;
}

inline void __syncwarp() { g_warp_barrier->arrive_and_wait(); }

inline int emu_element(uint32_t word, int i, bool is_signed) {
  const int b = (word >> (8 * i)) & 255;
  return is_signed && b >= 128 ? b - 256 : b;
}

// d += A B for a k depth of W (16 or 32): A register r byte i of lane (g, t)
// is A[g + 8 (r & 1)][4t + i + 16 (r >> 1)], B register s byte i is
// B[4t + i + 16 s][g], D register r is D[g + 8 (r >> 1)][2t + (r & 1)].
template <int W, bool A_SIGNED, bool B_SIGNED>
void emu_mma(int (&d)[4], const uint32_t* a, const uint32_t* b) {
  const int lane = emu_lane();
  for (int r = 0; r < W / 8; ++r) g_lane_slots[lane][r] = a[r];
  for (int s = 0; s < W / 16; ++s) g_lane_slots[lane][8 + s] = b[s];
  g_warp_barrier->arrive_and_wait();
  int am[16][32] = {}, bm[32][8] = {};
  for (int l = 0; l < 32; ++l) {
    const int g = l >> 2, t = l & 3;
    for (int r = 0; r < W / 8; ++r)
      for (int i = 0; i < 4; ++i)
        am[g + 8 * (r & 1)][4 * t + i + 16 * (r >> 1)] =
            emu_element(static_cast<uint32_t>(g_lane_slots[l][r]), i, A_SIGNED);
    for (int s = 0; s < W / 16; ++s)
      for (int i = 0; i < 4; ++i)
        bm[4 * t + i + 16 * s][g] =
            emu_element(static_cast<uint32_t>(g_lane_slots[l][8 + s]), i, B_SIGNED);
  }
  const int g = lane >> 2, t = lane & 3;
  for (int r = 0; r < 4; ++r) {
    int64_t acc = d[r];
    for (int k = 0; k < W; ++k) acc += static_cast<int64_t>(am[g + 8 * (r >> 1)][k]) * bm[k][2 * t + (r & 1)];
    d[r] = static_cast<int>(static_cast<uint32_t>(acc));
  }
  g_warp_barrier->arrive_and_wait();
}
