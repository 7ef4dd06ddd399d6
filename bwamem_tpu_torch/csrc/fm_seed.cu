// Device seeding for Hopper (sm_90a): the SMEM search and the SA walks of
// `mem --device-seed`, one thread per read (bwt_smem_all, bwt_smem1) or
// per SA row (bwt_sa), and the same kernels over an index split by block
// range over several cards (the _sh entries).
//
// Replaces the JAX package's three XLA programs (bwamem_tpu/ops/smem_jax.py;
// XLA, not Pallas):
// - bwt_smem_all: _smem_all_kernel, the whole first round of every read.
//   The thread walks its read's start pointer (an N run skipped at once),
//   runs smem1_dev at each frontier, and appends the SMEMs of length >=
//   min_seed_len in the host path's order (each call's emissions
//   reversed).  Row b of out: [cnt, ovf, qb[128], qe[128], x0[128],
//   x1[128], s[128]] int64, slots past cnt 0; past 128 seeds ovf is set.
// - bwt_smem1: _smem1_kernel, one call at per-read x and min_intv (the
//   split re-seed rounds of collect_smems_device); a read whose mask is 0
//   runs at x = qlen (nothing).  Row b: [ret, ovf, n, qb[64], qe[64],
//   x0[64], x1[64], s[64]] int64, slots past n 0.
// - bwt_sa: _sa_kernel, the LF walk of each row; int64 positions.
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
// addresses depend on the step before, so a thread runs at the latency of
// its gathers (from L2 when the tables fit its 50 MB), not at the card's
// memory rate.  A thread per read is the simple design; a warp per read,
// the tables' L2 residency and overlap with the extension kernel are later
// work.  The slot arrays (24 live intervals, 64 emissions) are local
// memory.
//
// Plain C interface, loaded with ctypes (ops/_build.py); each launcher
// returns cudaGetLastError().  The same file compiles with g++ against the
// host stand-in of <cuda_runtime.h> in tests/_simt/: each launcher then
// runs its grid in a loop on the calling thread (tests/
// test_torch_simt_seed.py).

#include <cstdint>
#include <cuda_runtime.h>

#include "fm_seed.cuh"

namespace {

using fmseed::kAllCap;
using fmseed::kMCap;
using fmseed::Occ;
using fmseed::ShardedOcc;

constexpr int kBlock = 64;

__device__ __forceinline__ int64_t thread_index() {
  return (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
}

// The first-round loop is the kernel's own body, not a device function:
// moved into one, the Occ kernel took 72 registers instead of 64 and ran
// 7% slower on chip_smoke.py's gate on an H100 (chip_tune.py --seed,
// against this body).
template <class Tab>
__global__ void __launch_bounds__(kBlock)
    smem_all_kernel(Tab ix, const uint8_t* __restrict__ q, int L,
                    const int64_t* __restrict__ qlen, int64_t B,
                    int64_t min_seed_len, int64_t* __restrict__ out) {
  const int64_t b = thread_index();
  if (b >= B) return;
  const uint8_t* qr = q + b * L;
  const int64_t len = qlen[b];
  int64_t* row = out + b * (2 + 5 * kAllCap);
  for (int k = 0; k < 2 + 5 * kAllCap; ++k) row[k] = 0;
  int64_t m[5 * kMCap];
  int64_t x = 0, cnt = 0;
  bool ovf = false;
  while (x < len) {
    if (qr[x] > 3) {  // an N run: jump past it
      while (x < L && qr[x] > 3) ++x;
      continue;
    }
    const fmseed::Smem1 r = fmseed::smem1_dev(ix, qr, len, x, 1, m);
    int64_t total = 0;
    for (int k = r.n - 1; k >= 0; --k) {
      if (m[1 * kMCap + k] - m[k] < min_seed_len) continue;
      const int64_t slot = cnt + total++;
      if (slot >= kAllCap) continue;
      for (int f = 0; f < 5; ++f) row[2 + f * kAllCap + slot] = m[f * kMCap + k];
    }
    cnt += total;
    ovf = ovf || r.ovf || cnt > kAllCap;
    if (cnt > kAllCap) cnt = kAllCap;
    x = r.ret;
  }
  row[0] = cnt;
  row[1] = ovf;
}

template <class Tab>
__global__ void __launch_bounds__(kBlock)
    smem1_kernel(Tab ix, const uint8_t* __restrict__ q, int L,
                 const int64_t* __restrict__ qlen,
                 const int64_t* __restrict__ x,
                 const int64_t* __restrict__ min_intv,
                 const uint8_t* __restrict__ mask, int64_t B,
                 int64_t* __restrict__ out) {
  const int64_t b = thread_index();
  if (b >= B) return;
  int64_t* row = out + b * (3 + 5 * kMCap);
  const int64_t xb = mask[b] ? x[b] : qlen[b];
  const fmseed::Smem1 r =
      fmseed::smem1_dev(ix, q + b * L, qlen[b], xb, min_intv[b], row + 3);
  for (int f = 0; f < 5; ++f)
    for (int k = r.n; k < kMCap; ++k) row[3 + f * kMCap + k] = 0;
  row[0] = r.ret;
  row[1] = r.ovf;
  row[2] = r.n;
}

template <class Tab>
__global__ void __launch_bounds__(kBlock)
    sa_kernel(Tab ix, const int64_t* __restrict__ ssa, int64_t n_ssa,
              int64_t sa_intv, const int64_t* __restrict__ rows, int64_t n,
              int64_t max_it, int64_t* __restrict__ out) {
  const int64_t k = thread_index();
  if (k >= n) return;
  out[k] = fmseed::sa_value_dev(ix, ssa, n_ssa, sa_intv, rows[k], max_it);
}

__global__ void __launch_bounds__(kBlock)
    rank4_kernel(ShardedOcc ix, const int64_t* __restrict__ rows, int64_t n,
                 int64_t* __restrict__ out) {
  const int64_t k = thread_index();
  if (k >= n) return;
  fmseed::rank4(ix, rows[k], out + 4 * k);
}

Occ make_occ(const void* occ, const void* pk, const void* va, const void* C,
             long long primary, long long n_rows) {
  return Occ{static_cast<const int32_t*>(occ),
             static_cast<const uint32_t*>(pk),
             static_cast<const uint32_t*>(va),
             static_cast<const int64_t*>(C), primary, n_rows};
}

}  // namespace

// A grid of ceil(n / kBlock) blocks of kBlock threads on `stream`; under
// g++ the same grid in a loop.
#ifdef __CUDACC__
#define FM_LAUNCH(kernel, n, stream, ...)                                  \
  do {                                                                     \
    if ((n) <= 0) return 0;                                                \
    kernel<<<(unsigned)(((n) + kBlock - 1) / kBlock), kBlock, 0,           \
             static_cast<cudaStream_t>(stream)>>>(__VA_ARGS__);            \
    return (int)cudaGetLastError();                                        \
  } while (0)
#else
#define FM_LAUNCH(kernel, n, stream, ...)                                  \
  do {                                                                     \
    (void)(stream);                                                        \
    blockDim.x = kBlock;                                                   \
    for (int64_t blk = 0; blk * kBlock < (n); ++blk) {                     \
      blockIdx.x = (unsigned)blk;                                          \
      for (unsigned t = 0; t < (unsigned)kBlock; ++t) {                    \
        threadIdx.x = t;                                                   \
        kernel(__VA_ARGS__);                                               \
      }                                                                    \
    }                                                                      \
    return 0;                                                              \
  } while (0)
#endif

extern "C" {

// The first SMEM round of B reads: q (B, L) uint8 codes (N and pad = 4),
// qlen (B,) int64, out (B, 2 + 5*128) int64.  The tables: occ (nb+1, 4)
// int32, pk and va (nb, 4) uint32, C (6,) int64.
int bwt_smem_all(const void* occ, const void* pk, const void* va,
                 const void* C, long long primary, long long n_rows,
                 const void* q, int L, const void* qlen, long long B,
                 long long min_seed_len, void* out, void* stream) {
  FM_LAUNCH(smem_all_kernel<Occ>, (int64_t)B, stream,
            make_occ(occ, pk, va, C, primary, n_rows),
            static_cast<const uint8_t*>(q), L,
            static_cast<const int64_t*>(qlen), (int64_t)B,
            (int64_t)min_seed_len, static_cast<int64_t*>(out));
}

// One bwt_smem1 call a read: x, min_intv (B,) int64, mask (B,) uint8 (0:
// the read runs at x = qlen), out (B, 3 + 5*64) int64.
int bwt_smem1(const void* occ, const void* pk, const void* va, const void* C,
              long long primary, long long n_rows, const void* q, int L,
              const void* qlen, const void* x, const void* min_intv,
              const void* mask, long long B, void* out, void* stream) {
  FM_LAUNCH(smem1_kernel<Occ>, (int64_t)B, stream,
            make_occ(occ, pk, va, C, primary, n_rows),
            static_cast<const uint8_t*>(q), L,
            static_cast<const int64_t*>(qlen),
            static_cast<const int64_t*>(x),
            static_cast<const int64_t*>(min_intv),
            static_cast<const uint8_t*>(mask), (int64_t)B,
            static_cast<int64_t*>(out));
}

// Text positions of n SA rows (int64): ssa (n_ssa,) int64 sampled every
// sa_intv rows; a walk gives up (0) after max_it steps.
int bwt_sa(const void* occ, const void* pk, const void* va, const void* C,
           long long primary, long long n_rows, const void* ssa,
           long long n_ssa, long long sa_intv, const void* rows, long long n,
           long long max_it, void* out, void* stream) {
  FM_LAUNCH(sa_kernel<Occ>, (int64_t)n, stream,
            make_occ(occ, pk, va, C, primary, n_rows),
            static_cast<const int64_t*>(ssa), (int64_t)n_ssa,
            (int64_t)sa_intv, static_cast<const int64_t*>(rows), (int64_t)n,
            (int64_t)max_it, static_cast<int64_t*>(out));
}

// The same four programs over a ShardedOcc (fm_seed.cuh) at *tab: every
// table pointer must be readable from the launching card.  rows (n,) int64
// in [0, n_rows]; out (n, 4) int64.
int bwt_rank4_sh(const ShardedOcc* tab, const void* rows, long long n,
                 void* out, void* stream) {
  FM_LAUNCH(rank4_kernel, (int64_t)n, stream, *tab,
            static_cast<const int64_t*>(rows), (int64_t)n,
            static_cast<int64_t*>(out));
}

// bwt_smem_all over the shards: arguments and out as bwt_smem_all's.
int bwt_smem_all_sh(const ShardedOcc* tab, const void* q, int L,
                    const void* qlen, long long B, long long min_seed_len,
                    void* out, void* stream) {
  FM_LAUNCH(smem_all_kernel<ShardedOcc>, (int64_t)B, stream, *tab,
            static_cast<const uint8_t*>(q), L,
            static_cast<const int64_t*>(qlen), (int64_t)B,
            (int64_t)min_seed_len, static_cast<int64_t*>(out));
}

// bwt_smem1 over the shards: arguments and out as bwt_smem1's.
int bwt_smem1_sh(const ShardedOcc* tab, const void* q, int L,
                 const void* qlen, const void* x, const void* min_intv,
                 const void* mask, long long B, void* out, void* stream) {
  FM_LAUNCH(smem1_kernel<ShardedOcc>, (int64_t)B, stream, *tab,
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
  FM_LAUNCH(sa_kernel<ShardedOcc>, (int64_t)n, stream, *tab, nullptr,
            tab->n_ssa, tab->sa_intv, static_cast<const int64_t*>(rows),
            (int64_t)n, (int64_t)max_it, static_cast<int64_t*>(out));
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
