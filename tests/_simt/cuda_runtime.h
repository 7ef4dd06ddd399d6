// A host stand-in for <cuda_runtime.h>, for compiling the port's CUDA
// pass body (bwamem_tpu_torch/csrc/band_pass.cuh) with g++ and running it
// on the CPU: see simt_emulate.cpp.  It declares only what that header
// uses.  The threads of one group run as cooperative fibers of one OS
// thread; every warp-level primitive is a collective that parks the
// calling fiber until the whole group has arrived.

#pragma once

#include <algorithm>
#include <cstddef>
#include <cstdint>

#define __device__
#define __global__
#define __forceinline__ inline
#define __launch_bounds__(n)

enum { cudaErrorInvalidValue = 1 };

struct SimtIdx {
  unsigned x;
};
extern SimtIdx threadIdx, blockIdx;

namespace simt {
// Every fiber of the running group hands in `v`; returns the array of all
// G values (indexed by the thread's number in the group) once all have.
const int* collective(int v);
int group_width();
int thread_in_group();
}  // namespace simt

inline int __shfl_sync(unsigned, int v, int src, int width) {
  return simt::collective(v)[src & (width - 1)];
}

inline int __shfl_up_sync(unsigned, int v, unsigned delta, int) {
  const int me = simt::thread_in_group();
  const int* all = simt::collective(v);
  return me >= (int)delta ? all[me - (int)delta] : v;
}

inline int __reduce_max_sync(unsigned, int v) {
  const int* all = simt::collective(v);
  return *std::max_element(all, all + simt::group_width());
}

inline int __reduce_min_sync(unsigned, int v) {
  const int* all = simt::collective(v);
  return *std::min_element(all, all + simt::group_width());
}

inline int __vimax3_s32(int a, int b, int c) {
  return std::max(a, std::max(b, c));
}

inline int __viaddmax_s32_relu(int a, int b, int c) {
  return std::max(std::max(a + b, c), 0);
}

// PTX prmt.b32 in its default mode: byte n of the result is byte s[4n+2:4n]
// of {y, x}, or that byte's sign over all 8 bits where s[4n+3] is set.
inline unsigned prmt_b32(unsigned x, unsigned y, unsigned s) {
  const uint64_t src = ((uint64_t)y << 32) | x;
  unsigned out = 0;
  for (int n = 0; n < 4; ++n) {
    const unsigned sel = (s >> (4 * n)) & 0xf;
    unsigned byte = (unsigned)(src >> (8 * (sel & 7))) & 0xff;
    if (sel & 8) byte = (byte & 0x80) ? 0xff : 0;
    out |= byte << (8 * n);
  }
  return out;
}

inline int __ffs(unsigned v) { return __builtin_ffs((int)v); }
inline int __clz(unsigned v) { return v ? __builtin_clz(v) : 32; }
