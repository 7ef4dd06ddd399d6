// A host stand-in for <cuda_runtime.h>, for compiling the port's CUDA
// sources with g++ and running them on the CPU: the pass body
// (bwamem_tpu_torch/csrc/band_pass.cuh, see simt_emulate.cpp), the
// mate-rescue and CIGAR bodies (csrc/local_sw.cuh, global_sw.cuh, see
// simt_sw_emulate.cpp) and the seeding kernels (csrc/fm_seed.cu, see
// simt_seed_emulate.cpp).  It declares only what those sources use.  The
// threads of one group (a warp, or the group of threads that shares an
// alignment) run as cooperative fibers of one OS thread; every warp-level
// primitive is a collective that parks the calling fiber until the whole
// group has arrived.  `__shared__` memory is a static: the emulators run
// one group at a time, so a group's own part of it is never touched by
// another while it runs.

#pragma once

#include <algorithm>
#include <cstddef>
#include <cstdint>

#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static

enum { cudaErrorInvalidValue = 1 };

// The launchers' queries of the card: declared (for the headers' host
// helpers), never called by the emulators.
enum cudaDeviceAttr {
  cudaDevAttrMultiProcessorCount,
  cudaDevAttrMaxSharedMemoryPerMultiprocessor,
  cudaDevAttrMaxSharedMemoryPerBlockOptin
};
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
int cudaGetDevice(int*);
int cudaDeviceGetAttribute(int*, cudaDeviceAttr, int);
template <class F>
int cudaOccupancyMaxActiveBlocksPerMultiprocessor(int*, F, int, size_t);
template <class F>
int cudaFuncSetAttribute(F, cudaFuncAttribute, int);

// the vector types the kernels load and store whole
struct int4 {
  int x, y, z, w;
};
struct uint4 {
  unsigned x, y, z, w;
};
struct longlong2 {
  long long x, y;
};

struct SimtIdx {
  unsigned x;
};
inline SimtIdx threadIdx, blockIdx, blockDim, gridDim;

namespace simt {
// Every fiber of the running group hands in `v`; returns the array of all
// G values (indexed by the thread's number in the group) once all have.
const long long* collective(long long v);
int group_width();
int thread_in_group();

template <class T>
inline T shfl(T v, int src, int width) {
  return (T)collective((long long)v)[src & (width - 1)];
}
}  // namespace simt

// 32- and 64-bit, as CUDA's overloads
inline int __shfl_sync(unsigned, int v, int src, int width = 32) {
  return simt::shfl(v, src, width);
}
inline unsigned __shfl_sync(unsigned, unsigned v, int src, int width = 32) {
  return simt::shfl(v, src, width);
}
inline long __shfl_sync(unsigned, long v, int src, int width = 32) {
  return simt::shfl(v, src, width);
}
inline long long __shfl_sync(unsigned, long long v, int src,
                             int width = 32) {
  return simt::shfl(v, src, width);
}

inline unsigned __shfl_xor_sync(unsigned, unsigned v, int mask,
                                int width = 32) {
  return simt::shfl(v, simt::thread_in_group() ^ mask, width);
}
inline long __shfl_xor_sync(unsigned, long v, int mask, int width = 32) {
  return simt::shfl(v, simt::thread_in_group() ^ mask, width);
}

inline int __shfl_up_sync(unsigned, int v, unsigned delta, int) {
  const int me = simt::thread_in_group();
  const long long* all = simt::collective(v);
  return me >= (int)delta ? (int)all[me - (int)delta] : v;
}

inline int __shfl_down_sync(unsigned, int v, unsigned delta, int width) {
  const int me = simt::thread_in_group();
  const long long* all = simt::collective(v);
  // (a thread with no thread `delta` above it in its width gets its own)
  return (me % width) + (int)delta < width ? (int)all[me + (int)delta] : v;
}

// bit k: thread k of the group passed a nonzero predicate
inline unsigned __ballot_sync(unsigned, int pred) {
  const long long* all = simt::collective(pred != 0);
  unsigned bits = 0;
  for (int k = 0; k < simt::group_width(); ++k)
    if (all[k]) bits |= 1u << k;
  return bits;
}

// the threads of the group below this one (PTX %lanemask_lt)
inline unsigned lanemask_lt() {
  return (1u << simt::thread_in_group()) - 1u;
}

// a barrier of the group (the fibers run in turn, so memory is in order)
inline void __syncwarp(unsigned = 0xffffffffu) { simt::collective(0); }

inline int __reduce_max_sync(unsigned, int v) {
  const long long* all = simt::collective(v);
  return (int)*std::max_element(all, all + simt::group_width());
}

inline int __reduce_min_sync(unsigned, int v) {
  const long long* all = simt::collective(v);
  return (int)*std::min_element(all, all + simt::group_width());
}

inline int __vimax3_s32(int a, int b, int c) {
  return std::max(a, std::max(b, c));
}

inline int __viaddmax_s32_relu(int a, int b, int c) {
  return std::max(std::max(a + b, c), 0);
}

// The packed 16-bit DPX intrinsics, with the semantics of the CUDA math
// API: each half of the 32-bit word is a signed 16-bit integer, sums wrap.
namespace simt {
inline int16_t half(unsigned v, int k) { return (int16_t)(v >> (16 * k)); }
template <class F>
inline unsigned per_half(F f) {
  return (unsigned)(uint16_t)f(0) | ((unsigned)(uint16_t)f(1) << 16);
}
inline int16_t wrap_add(int16_t a, int16_t b) {
  return (int16_t)(uint16_t)((unsigned)a + (unsigned)b);
}
}  // namespace simt

inline unsigned __viaddmax_s16x2(unsigned a, unsigned b, unsigned c) {
  return simt::per_half([&](int k) {
    return std::max(simt::wrap_add(simt::half(a, k), simt::half(b, k)),
                    simt::half(c, k));
  });
}

inline unsigned __viaddmax_s16x2_relu(unsigned a, unsigned b, unsigned c) {
  return simt::per_half([&](int k) {
    return std::max<int16_t>(
        std::max(simt::wrap_add(simt::half(a, k), simt::half(b, k)),
                 simt::half(c, k)),
        0);
  });
}

inline unsigned __viaddmin_s16x2(unsigned a, unsigned b, unsigned c) {
  return simt::per_half([&](int k) {
    return std::min(simt::wrap_add(simt::half(a, k), simt::half(b, k)),
                    simt::half(c, k));
  });
}

inline unsigned __vimax3_s16x2(unsigned a, unsigned b, unsigned c) {
  return simt::per_half([&](int k) {
    return std::max(simt::half(a, k),
                    std::max(simt::half(b, k), simt::half(c, k)));
  });
}

inline unsigned __vimin3_s16x2(unsigned a, unsigned b, unsigned c) {
  return simt::per_half([&](int k) {
    return std::min(simt::half(a, k),
                    std::min(simt::half(b, k), simt::half(c, k)));
  });
}

// max(a, b) per half; each predicate says whether a's half was >= b's
inline unsigned __vibmax_s16x2(unsigned a, unsigned b, bool* pred_hi,
                               bool* pred_lo) {
  *pred_lo = simt::half(a, 0) >= simt::half(b, 0);
  *pred_hi = simt::half(a, 1) >= simt::half(b, 1);
  return simt::per_half(
      [&](int k) { return std::max(simt::half(a, k), simt::half(b, k)); });
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

inline int __popc(unsigned v) { return __builtin_popcount(v); }
inline int __popcll(unsigned long long v) { return __builtin_popcountll(v); }
inline int __ffs(unsigned v) { return __builtin_ffs((int)v); }
inline int __clz(unsigned v) { return v ? __builtin_clz(v) : 32; }
