// What the mate-rescue and CIGAR kernels (local_sw.cu, global_sw.cu) share:
// the strip of query columns that each thread of a group owns, the group's
// shuffle mask and prefix maximum, and the shape of a launch.
//
// A group of G threads (a warp, or an 8- or 16-thread tile of one where the
// query window is short) runs one task at a time; thread k owns the strip
// of query columns [k*C, (k+1)*C).  The strip's H and E cells and query
// codes live in registers (RegRow, every loop over the strip unrolled)
// for windows up to 256 columns, and above that in a slot of global
// scratch (MemRow: element c of thread k at word c*G + k, so a group's
// accesses are contiguous), for any window.  The grid has a bounded number
// of groups, each walking the tasks with a stride of all of them, so a
// slot (the memory row, a kernel's per-task scratch) belongs to a group,
// not to a task, and the scratch does not grow with the batch past
// kMaxBlocks blocks.
//
// Every function here is inline or a template, so each source may include
// it (each gets its own device code: no -rdc); ops/_build.py hashes the
// headers with the sources.
// The same headers compile with g++ against tests/_simt/cuda_runtime.h,
// where tests/_simt/simt_sw_emulate.cpp runs the kernel bodies with the
// threads of a group as fibers.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace sw {

constexpr int kThreads = 128;   // threads a block, every kernel and shape
constexpr int64_t kMaxBlocks = 2048;
// no launch's scratch goes past this many bytes unless one block's slots
// alone need more
constexpr int64_t kScratchCap = (int64_t)1 << 30;

__device__ __forceinline__ int imax(int x, int y) { return x > y ? x : y; }
__device__ __forceinline__ int imin(int x, int y) { return x < y ? x : y; }
// a base code as an index into a row of the 5x5 matrix
__device__ __forceinline__ int code04(int c) {
  return c < 0 ? 0 : (c > 4 ? 4 : c);
}

// The threads of this thread's group, as a shuffle mask.
template <int G>
__device__ __forceinline__ unsigned group_mask() {
  if constexpr (G == 32) {
    return 0xffffffffu;
  } else {
    return ((1u << G) - 1u) << ((threadIdx.x & 31) & ~(G - 1));
  }
}

// The maximum of v over the threads of the group below this one (the
// value of thread 0 is `none`).
template <int G>
__device__ __forceinline__ int exclusive_max(int v, int tg, unsigned gmask,
                                             int none) {
#pragma unroll
  for (int d = 1; d < G; d <<= 1) {
    // (a thread with none d below it gets its own value back)
    v = imax(v, __shfl_up_sync(gmask, v, d, G));
  }
  v = __shfl_up_sync(gmask, v, 1, G);
  return tg == 0 ? none : v;
}

// A strip of C columns in registers.
template <int C>
struct RegRow {
  static constexpr int kC = C;
  int hv[C], ev[C], qv[C];
  __device__ __forceinline__ int ncol() const { return C; }
  __device__ __forceinline__ int h(int c) const { return hv[c]; }
  __device__ __forceinline__ int e(int c) const { return ev[c]; }
  __device__ __forceinline__ int q(int c) const { return qv[c]; }
  __device__ __forceinline__ void set_h(int c, int v) { hv[c] = v; }
  __device__ __forceinline__ void set_e(int c, int v) { ev[c] = v; }
  __device__ __forceinline__ void set_q(int c, int v) { qv[c] = v; }
};

// A strip of n columns in the group's slot of global memory: H, E words
// and the query code byte of column c of thread tg at c*G + tg.
struct MemRow {
  static constexpr int kC = 0;
  int* hp;
  int* ep;
  int8_t* qp;
  int n, g;
  __device__ __forceinline__ int ncol() const { return n; }
  __device__ __forceinline__ int h(int c) const { return hp[c * g]; }
  __device__ __forceinline__ int e(int c) const { return ep[c * g]; }
  __device__ __forceinline__ int q(int c) const { return qp[c * g]; }
  __device__ __forceinline__ void set_h(int c, int v) { hp[c * g] = v; }
  __device__ __forceinline__ void set_e(int c, int v) { ep[c * g] = v; }
  __device__ __forceinline__ void set_q(int c, int v) {
    qp[c * g] = (int8_t)v;
  }
};

// Columns a thread owns for a window of qmax columns: C, or for the memory
// row ceil(qmax / G).
template <int G, int C>
__host__ __device__ inline int strip_cols(int qmax) {
  return C > 0 ? C : (qmax + G - 1) / G;
}

// Bytes of a group's memory row (0 for a row in registers), a multiple of 16.
template <int G, int C>
inline int64_t mem_row_bytes(int qmax) {
  if (C > 0) return 0;
  const int64_t cols = (int64_t)strip_cols<G, C>(qmax) * G;
  return (cols * 9 + 15) / 16 * 16;
}

// The memory row of thread tg in a slot that starts with it.
template <int G>
__device__ __forceinline__ MemRow mem_row(unsigned char* slot, int tg,
                                          int ncol) {
  const int64_t words = (int64_t)ncol * G;
  int* ints = reinterpret_cast<int*>(slot);
  MemRow r;
  r.hp = ints + tg;
  r.ep = ints + words + tg;
  r.qp = reinterpret_cast<int8_t*>(ints + 2 * words) + tg;
  r.n = ncol;
  r.g = G;
  return r;
}

// The row of thread tg: registers, or (C == 0) the memory row at the start
// of the group's slot.
template <int G, int C>
__device__ __forceinline__ auto make_row(unsigned char* slot, int tg,
                                         int ncol) {
  if constexpr (C > 0) {
    return RegRow<C>{};
  } else {
    return mem_row<G>(slot, tg, ncol);
  }
}

// The grid of a launch over B tasks with groups of G threads, each group
// with a slot of slot_bytes: blocks, and the scratch bytes of all slots.
template <int G>
inline void launch_grid(int64_t B, int64_t slot_bytes, unsigned* blocks,
                        int64_t* scratch) {
  const int64_t per_block = kThreads / G;
  int64_t n = (B + per_block - 1) / per_block;
  if (n > kMaxBlocks) n = kMaxBlocks;
  if (slot_bytes > 0) {
    int64_t cap = kScratchCap / (slot_bytes * per_block);
    if (cap < 1) cap = 1;
    if (n > cap) n = cap;
  }
  if (n < 1) n = 1;
  *blocks = (unsigned)n;
  *scratch = n * per_block * slot_bytes;
}

// This thread's group: its number in the grid, the number of groups in the
// grid, and the thread's number in the group.
template <int G>
struct GroupIdx {
  int64_t group, groups;
  int tg;
};
template <int G>
__device__ __forceinline__ GroupIdx<G> group_idx() {
  GroupIdx<G> r;
  r.tg = threadIdx.x & (G - 1);
  r.group = (int64_t)blockIdx.x * (kThreads / G) + threadIdx.x / G;
  r.groups = (int64_t)gridDim.x * (kThreads / G);
  return r;
}

// Calls fn.template run<G, C>() with the group width and strip length for
// a query window of qmax columns: a strip in registers up to 256 columns,
// the memory row (C == 0) of a whole warp above.
#define BWT_SW_TABLE(ROW)                                          \
  ROW(32, 8, 4) ROW(64, 16, 4) ROW(128, 32, 4) ROW(160, 32, 5)     \
  ROW(192, 32, 6) ROW(256, 32, 8)

template <class Fn>
inline auto dispatch_sw(int qmax, Fn&& fn)
    -> decltype(fn.template run<32, 0>()) {
#define BWT_ROW(QMAX, G, C) \
  if (qmax <= QMAX) return fn.template run<G, C>();
  BWT_SW_TABLE(BWT_ROW)
#undef BWT_ROW
  return fn.template run<32, 0>();
}

}  // namespace sw
