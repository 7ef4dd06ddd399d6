// Device seeding for Hopper (sm_90a): the SMEM search and the SA walks of
// `mem --device-seed`, a warp per read (bwt_smem_all, bwt_smem1) or a
// thread per SA row (bwt_sa), and the same kernels over an index split by
// block range over several cards (the _sh entries).
//
// Replaces the JAX package's three XLA programs (bwamem_tpu/ops/smem_jax.py;
// XLA, not Pallas):
// - bwt_smem_all: _smem_all_kernel, the whole first round of every read.
//   The warp walks its read's start pointer (an N run skipped at once),
//   runs smem1_warp at each frontier, and appends the SMEMs of length >=
//   min_seed_len in the host path's order (each call's emissions
//   reversed).  Row b of out: [cnt, ovf, qb[128], qe[128], x0[128],
//   x1[128], s[128]] int64, slots past cnt 0; past 128 seeds ovf is set.
// - bwt_smem1: _smem1_kernel, one call at per-read x and min_intv (the
//   split re-seed rounds of collect_smems_device); a read whose mask is 0
//   runs at x = qlen (nothing).  Row b: [ret, ovf, n, qb[64], qe[64],
//   x0[64], x1[64], s[64]] int64, slots past n 0.
// - bwt_sa: _sa_kernel, the LF walk of each row; int64 positions.  A
//   thread walks a row: each step reads its block's 64-byte record (one
//   DRAM line and one translation when the tables outgrow L2), counts only
//   the base the step follows, and finds the sampled rows by a mask and a
//   shift (a power-of-two sa_intv; a division otherwise).  At an index in
//   DRAM the walks of a launch are bound by the card's rate of random
//   line reads, each walk by its chain of dependent loads.
// Every output equals the plain PyTorch version (ops/smem_torch.py) and,
// at positions below 2^31, the JAX programs.
//
// The _sh entries take a ShardedOcc (fm_seed.cuh) by value and replace the
// XLA programs of the JAX package's table-sharded regime
// (bwamem_tpu/ops/smem_sharded.py, for an index of 2^31 rows or more):
// - bwt_rank4_sh: make_sharded_rank4 (:579), rank4 of n int64 rows;
// - bwt_smem_all_sh: _smem_all_wide (:436);
// - bwt_smem1_sh: _smem1_wide (:254);
// - bwt_sa_sh: _sa_wide (:506).
// Where the JAX programs answer each gather with a masked psum over the
// mesh and carry positions as (hi, lo) int32 pairs, a thread here computes
// the owning shard of a block and reads it through that shard's pointer,
// with int64 positions.  The same outputs as the Occ kernels, row for row.
//
// What bounds it: each extension step is a pair of rank4 queries whose
// addresses depend on the step before, so a read runs at the latency of
// its chain of gathers (from L2 when the tables fit its 50 MB), not at the
// card's memory rate.  A warp per read, four reads a block, puts a
// 2,048-read chunk on 512 blocks over the 132 SMs, holds the live
// intervals one a lane in registers, and runs a backward step's
// extensions of every live interval at once, so a step costs one round
// of gathers; the forward pass stays one chain, each step's two gathers
// split over eight lanes.  A call's
// emissions are kept in the warp's shared memory (bwt_smem_all) or
// written straight into the row (bwt_smem1); rows are zeroed by the warp.
// What bounds it still is each read's chain of dependent gathers; not yet
// done: the tables pinned in L2, and overlap with the extension kernel.
//
// Plain C interface, loaded with ctypes (ops/_build.py); each launcher
// returns cudaGetLastError().  tests/_simt/simt_seed_emulate.cpp compiles
// this file with g++ against the host stand-in of <cuda_runtime.h> in
// tests/_simt/, with its own FM_LAUNCH that runs each warp of the grid as
// fibers (tests/test_torch_simt_seed.py).

#include <cstdint>
#include <cuda_runtime.h>

#include "fm_seed.cuh"

namespace {

using fmseed::kAllCap;
using fmseed::kFull;
using fmseed::kMCap;
using fmseed::Occ;
using fmseed::ShardedOcc;

constexpr int kWarps = 4;                  // reads a block (SMEM kernels)
constexpr int kWarpBlock = 32 * kWarps;
constexpr int kRowBlock = 64;              // rows a block (SA)
constexpr int kRank4Block = 256;           // threads a block (rank4)
constexpr int kRank4Rows = 4;              // rows a thread (rank4)

// This thread's read and lane: warp w of block k runs read k * kWarps + w.
__device__ __forceinline__ int64_t warp_read() {
  return (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
}

__device__ __forceinline__ int64_t thread_index() {
  return (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
}

template <class Tab>
__global__ void __launch_bounds__(kWarpBlock)
    smem_all_kernel(Tab ix, const uint8_t* __restrict__ q, int L,
                    const int64_t* __restrict__ qlen, int64_t B,
                    int64_t min_seed_len, int64_t* __restrict__ out) {
  __shared__ int64_t em_all[kWarps][5 * kMCap];  // one call's emissions
  const int64_t b = warp_read();
  if (b >= B) return;
  const int lane = (int)(threadIdx.x & 31u);
  int64_t* em = em_all[threadIdx.x >> 5];
  const uint8_t* qr = q + b * L;
  const int64_t len = qlen[b];
  int64_t* row = out + b * (2 + 5 * kAllCap);
  int64_t x = 0, cnt = 0;
  bool ovf = false;
  while (x < len) {
    if (qr[x] > 3) {  // an N run: jump past it
      while (x < L && qr[x] > 3) ++x;
      continue;
    }
    const fmseed::Smem1 r = fmseed::smem1_warp(ix, qr, len, x, 1, em);
    __syncwarp();
    // the call's emissions reversed and length-filtered: emission k (lanes
    // k and k - 32 hold k) goes to slot cnt + the kept emissions above k
    bool keep[2];
    unsigned bal[2];
    for (int h = 0; h < 2; ++h) {
      const int k = lane + 32 * h;
      keep[h] = k < r.n && em[kMCap + k] - em[k] >= min_seed_len;
      bal[h] = __ballot_sync(kFull, keep[h]);
    }
    const unsigned long long kept =
        bal[0] | (unsigned long long)bal[1] << 32;
    for (int h = 0; h < 2; ++h) {
      const int k = lane + 32 * h;
      const int64_t slot = cnt + __popcll(kept >> k >> 1);
      if (keep[h] && slot < kAllCap)
        for (int f = 0; f < 5; ++f)
          row[2 + f * kAllCap + slot] = em[f * kMCap + k];
    }
    cnt += __popcll(kept);
    ovf = ovf || r.ovf || cnt > kAllCap;
    if (cnt > kAllCap) cnt = kAllCap;
    x = r.ret;
    __syncwarp();  // every lane has read em before the next call writes it
  }
  for (int k = lane; k < 5 * kAllCap; k += 32)
    if (k % kAllCap >= cnt) row[2 + k] = 0;
  if (lane == 0) {
    row[0] = cnt;
    row[1] = ovf;
  }
}

template <class Tab>
__global__ void __launch_bounds__(kWarpBlock)
    smem1_kernel(Tab ix, const uint8_t* __restrict__ q, int L,
                 const int64_t* __restrict__ qlen,
                 const int64_t* __restrict__ x,
                 const int64_t* __restrict__ min_intv,
                 const uint8_t* __restrict__ mask, int64_t B,
                 int64_t* __restrict__ out) {
  const int64_t b = warp_read();
  if (b >= B) return;
  const int lane = (int)(threadIdx.x & 31u);
  int64_t* row = out + b * (3 + 5 * kMCap);
  const int64_t xb = mask[b] ? x[b] : qlen[b];
  const fmseed::Smem1 r =
      fmseed::smem1_warp(ix, q + b * L, qlen[b], xb, min_intv[b], row + 3);
  for (int k = lane; k < 5 * kMCap; k += 32)
    if (k % kMCap >= r.n) row[3 + k] = 0;
  if (lane == 0) {
    row[0] = r.ret;
    row[1] = r.ovf;
    row[2] = r.n;
  }
}

template <class Tab>
__global__ void __launch_bounds__(kRowBlock)
    sa_kernel(Tab ix, const int64_t* __restrict__ ssa, int64_t n_ssa,
              int64_t sa_intv, int sa_shift,
              const int64_t* __restrict__ rows, int64_t n, int64_t max_it,
              int64_t* __restrict__ out) {
  const int64_t k = thread_index();
  if (k >= n) return;
  out[k] = fmseed::sa_value_dev(ix, ssa, n_ssa, sa_intv, sa_shift, rows[k],
                                max_it);
}

// rank4 of kRank4Rows rows a thread (rows t, t + kRank4Block, ... of the
// block's span, so a warp's reads and writes of each are contiguous): the
// row indices loaded, then every row's record (three 16-byte loads), then
// the counts, two 16-byte stores a row.
__global__ void __launch_bounds__(kRank4Block)
    rank4_kernel(ShardedOcc ix, const int64_t* __restrict__ rows, int64_t n,
                 int64_t* __restrict__ out) {
  const int64_t first =
      (int64_t)blockIdx.x * (kRank4Block * kRank4Rows) + threadIdx.x;
  int64_t row[kRank4Rows];
  fmseed::BlockRows b[kRank4Rows];
  for (int k = 0; k < kRank4Rows; ++k) {
    const int64_t at = first + (int64_t)k * kRank4Block;
    row[k] = at < n ? rows[at] : 0;
  }
  for (int k = 0; k < kRank4Rows; ++k)
    if (first + (int64_t)k * kRank4Block < n)
      b[k] = fmseed::load_rows(fmseed::block_of(ix, row[k] >> 6));
  for (int k = 0; k < kRank4Rows; ++k) {
    const int64_t at = first + (int64_t)k * kRank4Block;
    if (at >= n) continue;
    int64_t c[4];
    fmseed::rank4_rows(b[k], (int)(row[k] & 63), c);
    longlong2* dst = reinterpret_cast<longlong2*>(out + 4 * at);
    dst[0] = longlong2{c[0], c[1]};
    dst[1] = longlong2{c[2], c[3]};
  }
}

Occ make_occ(const void* rec, const void* C, long long primary,
             long long n_rows) {
  return Occ{static_cast<const int32_t*>(rec),
             static_cast<const int64_t*>(C), primary, n_rows};
}

// log2(v) for a power of two v, -1 for any other v (the walks' sa_shift).
int exact_log2(long long v) {
  if (v <= 0 || (v & (v - 1))) return -1;
  int s = 0;
  while ((1LL << s) != v) ++s;
  return s;
}

}  // namespace

// ceil(n / per_block) blocks of `threads` threads on `stream`.
#ifndef FM_LAUNCH
#define FM_LAUNCH(kernel, n, per_block, threads, stream, ...)              \
  do {                                                                     \
    if ((n) <= 0) return 0;                                                \
    kernel<<<(unsigned)(((n) + (per_block) - 1) / (per_block)), (threads), \
             0, static_cast<cudaStream_t>(stream)>>>(__VA_ARGS__);         \
    return (int)cudaGetLastError();                                        \
  } while (0)
#endif
// a warp per read, or a thread per row
#define FM_LAUNCH_READS(kernel, n, stream, ...) \
  FM_LAUNCH(kernel, n, kWarps, kWarpBlock, stream, __VA_ARGS__)
#define FM_LAUNCH_ROWS(kernel, n, stream, ...) \
  FM_LAUNCH(kernel, n, kRowBlock, kRowBlock, stream, __VA_ARGS__)

extern "C" {

// The first SMEM round of B reads: q (B, L) uint8 codes (N and pad = 4),
// qlen (B,) int64, out (B, 2 + 5*128) int64.  The tables: rec (nb+1, 16)
// int32 block records (fm_seed.cuh), 64-byte aligned, C (6,) int64.
int bwt_smem_all(const void* rec, const void* C, long long primary,
                 long long n_rows, const void* q, int L, const void* qlen,
                 long long B, long long min_seed_len, void* out,
                 void* stream) {
  FM_LAUNCH_READS(smem_all_kernel<Occ>, (int64_t)B, stream,
            make_occ(rec, C, primary, n_rows),
            static_cast<const uint8_t*>(q), L,
            static_cast<const int64_t*>(qlen), (int64_t)B,
            (int64_t)min_seed_len, static_cast<int64_t*>(out));
}

// One bwt_smem1 call a read: x, min_intv (B,) int64, mask (B,) uint8 (0:
// the read runs at x = qlen), out (B, 3 + 5*64) int64.
int bwt_smem1(const void* rec, const void* C, long long primary,
              long long n_rows, const void* q, int L, const void* qlen,
              const void* x, const void* min_intv, const void* mask,
              long long B, void* out, void* stream) {
  FM_LAUNCH_READS(smem1_kernel<Occ>, (int64_t)B, stream,
            make_occ(rec, C, primary, n_rows),
            static_cast<const uint8_t*>(q), L,
            static_cast<const int64_t*>(qlen),
            static_cast<const int64_t*>(x),
            static_cast<const int64_t*>(min_intv),
            static_cast<const uint8_t*>(mask), (int64_t)B,
            static_cast<int64_t*>(out));
}

// Text positions of n SA rows (int64): ssa (n_ssa,) int64 sampled every
// sa_intv rows; a walk gives up (0) after max_it steps.
int bwt_sa(const void* rec, const void* C, long long primary,
           long long n_rows, const void* ssa, long long n_ssa,
           long long sa_intv, const void* rows, long long n,
           long long max_it, void* out, void* stream) {
  FM_LAUNCH_ROWS(sa_kernel<Occ>, (int64_t)n, stream,
            make_occ(rec, C, primary, n_rows),
            static_cast<const int64_t*>(ssa), (int64_t)n_ssa,
            (int64_t)sa_intv, exact_log2(sa_intv),
            static_cast<const int64_t*>(rows), (int64_t)n, (int64_t)max_it,
            static_cast<int64_t*>(out));
}

// The same four programs over a ShardedOcc (fm_seed.cuh) at *tab: every
// table pointer must be readable from the launching card.  rows (n,) int64
// in [0, n_rows]; out (n, 4) int64.
int bwt_rank4_sh(const ShardedOcc* tab, const void* rows, long long n,
                 void* out, void* stream) {
  FM_LAUNCH(rank4_kernel, (int64_t)n, kRank4Block * kRank4Rows,
            kRank4Block, stream, *tab,
            static_cast<const int64_t*>(rows), (int64_t)n,
            static_cast<int64_t*>(out));
}

// bwt_smem_all over the shards: arguments and out as bwt_smem_all's.
int bwt_smem_all_sh(const ShardedOcc* tab, const void* q, int L,
                    const void* qlen, long long B, long long min_seed_len,
                    void* out, void* stream) {
  FM_LAUNCH_READS(smem_all_kernel<ShardedOcc>, (int64_t)B, stream, *tab,
            static_cast<const uint8_t*>(q), L,
            static_cast<const int64_t*>(qlen), (int64_t)B,
            (int64_t)min_seed_len, static_cast<int64_t*>(out));
}

// bwt_smem1 over the shards: arguments and out as bwt_smem1's.
int bwt_smem1_sh(const ShardedOcc* tab, const void* q, int L,
                 const void* qlen, const void* x, const void* min_intv,
                 const void* mask, long long B, void* out, void* stream) {
  FM_LAUNCH_READS(smem1_kernel<ShardedOcc>, (int64_t)B, stream, *tab,
            static_cast<const uint8_t*>(q), L,
            static_cast<const int64_t*>(qlen),
            static_cast<const int64_t*>(x),
            static_cast<const int64_t*>(min_intv),
            static_cast<const uint8_t*>(mask), (int64_t)B,
            static_cast<int64_t*>(out));
}

// bwt_sa over the shards (the sampled SA is the table's): n rows, a walk
// gives up (0) after max_it steps.
int bwt_sa_sh(const ShardedOcc* tab, const void* rows, long long n,
              long long max_it, void* out, void* stream) {
  FM_LAUNCH_ROWS(sa_kernel<ShardedOcc>, (int64_t)n, stream, *tab, nullptr,
            tab->n_ssa, tab->sa_intv, exact_log2(tab->sa_intv),
            static_cast<const int64_t*>(rows), (int64_t)n, (int64_t)max_it,
            static_cast<int64_t*>(out));
}

#ifdef __CUDACC__
// Let card `dev` read the memory of card `peer` (cudaDeviceEnablePeerAccess
// from dev's context); access already enabled counts as success.  Returns
// the CUDA error code, 0 on success; the current device is left as it was.
int bwt_enable_peer_access(int dev, int peer) {
  int prev = 0;
  cudaError_t e = cudaGetDevice(&prev);
  if (e != cudaSuccess) return (int)e;
  e = cudaSetDevice(dev);
  if (e == cudaSuccess) {
    e = cudaDeviceEnablePeerAccess(peer, 0);
    if (e == cudaErrorPeerAccessAlreadyEnabled) {
      (void)cudaGetLastError();  // not a sticky error: clear it
      e = cudaSuccess;
    }
  }
  const cudaError_t e2 = cudaSetDevice(prev);
  return (int)(e != cudaSuccess ? e : e2);
}
#endif

}  // extern "C"
