// FM-index seeding on the device, one thread per read or per SA row: the
// __device__ functions of fm_seed.cu, templated on the table type.
//
// They compute what the JAX package's lockstep seeding programs compute
// (bwamem_tpu/ops/smem_jax.py: _smem1_kernel, _smem_all_kernel,
// _sa_kernel; over block-range table shards, bwamem_tpu/ops/
// smem_sharded.py: _smem1_wide, _smem_all_wide, _sa_wide), with the plain
// PyTorch version (ops/smem_torch.py) as their specification, and they
// keep the JAX programs' caps and overflow rules, not the C++ engine's
// growing vectors (csrc/smem.cpp):
// - the forward pass keeps at most kPCap = 24 intervals; a push beyond that
//   is dropped and sets the overflow flag (smem_jax.py:152-162);
// - a call emits at most kMCap = 64 SMEMs, and a call that reaches 64 sets
//   the flag (:277-294);
// - the backward step keeps a slot unless its extension stops, pushes a
//   kept slot unless its size equals the last kept slot's, and emits only
//   the first stopping slot before any kept one (:248-286), here as the
//   scalar loop of bwt_smem1 that the vector form was proved equal to.
// A read whose flag is set is searched again by the host's exact scalar
// smem1, as in the JAX package.
//
// The tables are the packed occ layout of index/occ_packed.py: per
// 64-symbol block a row of four int32 checkpoints and four 32-bit words of
// 2-bit symbols (pk) and of 0b01 validity lanes (va).  A rank4 query reads
// one 48-byte block (16 B of each); everything else is integer work in
// registers and the thread's slot arrays (local memory).  Positions are
// int64.  What bounds a thread is the chain of dependent gathers, one
// rank4 pair an extension step: see fm_seed.cu.
//
// Two table types: Occ, the whole index on the thread's own card, and
// ShardedOcc, the index split by block range over up to kMaxShards cards
// (ops/smem_sharded.py).  They differ only in block_of (where a block's
// three rows lie) and sample_at (where a sampled-SA entry lies); the
// search, the walks and their caps are one code for both.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace fmseed {

constexpr int kPCap = 24;     // live intervals of one call (P_CAP)
constexpr int kMCap = 64;     // SMEMs one call emits (M_CAP)
constexpr int kAllCap = 128;  // first-round SMEMs a read (ALL_CAP)

struct Occ {
  const int32_t* occ;  // (nb + 1) x 4 checkpoints
  const uint32_t* pk;  // nb x 4 packed symbols
  const uint32_t* va;  // nb x 4 validity lanes
  const int64_t* C;    // 6 entries
  int64_t primary;
  int64_t n_rows;
};

constexpr int kMaxShards = 8;  // BASELINE config #4: one host, 8 chips

// The tables split by contiguous 64-symbol block ranges (the layout of
// ShardedSeedTables in ops/smem_sharded.py): shard k holds the global
// blocks [blk_origin + k*nb_loc, blk_origin + (k+1)*nb_loc) as nb_loc rows
// of occ, pk and va, and the sampled-SA entries [k*ns_loc, (k+1)*ns_loc).
// Each pointer is a device pointer on its shard's card; a thread reads the
// owner's memory directly (over NVLink, with peer access, when the owner is
// another card).  Passed to the kernels by value; every member is 8 bytes
// wide, so the ctypes mirror in ops/_build.py has no padding to match.
struct ShardedOcc {
  const int32_t* occ[kMaxShards];  // nb_loc x 4 checkpoints a shard
  const uint32_t* pk[kMaxShards];  // nb_loc x 4 packed symbols
  const uint32_t* va[kMaxShards];  // nb_loc x 4 validity lanes
  const int64_t* ssa[kMaxShards];  // ns_loc sampled-SA entries
  int64_t C[6];
  int64_t primary;
  int64_t n_rows;
  int64_t nb_loc;
  int64_t ns_loc;
  int64_t blk_origin;  // global block of shard 0's first row
  int64_t n_ssa;
  int64_t sa_intv;
  int64_t n_shards;
};

// The three rows of global block blk.
struct Block {
  const int32_t* occ;
  const uint32_t* pk;
  const uint32_t* va;
};

__device__ __forceinline__ Block block_of(const Occ& ix, int64_t blk) {
  return Block{ix.occ + blk * 4, ix.pk + blk * 4, ix.va + blk * 4};
}

// The owning shard and the local row: the GPU counterpart of the JAX
// module's masked gather and psum (_rank4_partial, smem_sharded.py:186).
__device__ __forceinline__ Block block_of(const ShardedOcc& ix, int64_t blk) {
  const int64_t g = blk - ix.blk_origin;
  const int64_t s = g / ix.nb_loc;
  const int64_t l = (g - s * ix.nb_loc) * 4;
  return Block{ix.occ[s] + l, ix.pk[s] + l, ix.va[s] + l};
}

// Sampled-SA entry k.
__device__ __forceinline__ int64_t sample_at(const Occ&, const int64_t* ssa,
                                             int64_t k) {
  return ssa[k];
}

__device__ __forceinline__ int64_t sample_at(const ShardedOcc& ix,
                                             const int64_t*, int64_t k) {
  const int64_t s = k / ix.ns_loc;
  return ix.ssa[s][k - s * ix.ns_loc];
}

// Counts of bases 0..3 in bwt[0:i).
template <class Tab>
__device__ __forceinline__ void rank4(const Tab& ix, int64_t i,
                                      int64_t out[4]) {
  const int64_t blk = i >> 6;
  const int r = (int)(i & 63);
  const Block b = block_of(ix, blk);
  const uint32_t* w = b.pk;
  const uint32_t* v = b.va;
  const int32_t* base = b.occ;
  uint32_t wk[4], vk[4];
  for (int k = 0; k < 4; ++k) {
    const int nsym = r - 16 * k;
    const uint32_t pmask = nsym >= 16 ? 0xFFFFFFFFu
                           : nsym <= 0 ? 0u
                                       : ((1u << (2 * nsym)) - 1u);
    wk[k] = pmask ? w[k] : 0u;
    vk[k] = pmask ? (v[k] & pmask) : 0u;
  }
  for (int c = 0; c < 4; ++c) {
    const uint32_t pat = 0x55555555u * (uint32_t)c;
    int64_t cnt = base[c];
    for (int k = 0; k < 4; ++k) {
      const uint32_t t = ~(wk[k] ^ pat);
      cnt += __popc(t & (t >> 1) & 0x55555555u & vk[k]);
    }
    out[c] = cnt;
  }
}

// bwt_extend, is_back = 1: the four backward extensions of (x0, x1, s).
template <class Tab>
__device__ __forceinline__ void extend_back4(const Tab& ix, int64_t x0,
                                             int64_t x1, int64_t s,
                                             int64_t nx0[4], int64_t nx1[4],
                                             int64_t ns[4]) {
  int64_t tk[4], tl[4];
  rank4(ix, x0, tk);
  rank4(ix, x0 + s, tl);
  for (int c = 0; c < 4; ++c) {
    ns[c] = tl[c] - tk[c];
    nx0[c] = ix.C[c] + tk[c];
  }
  nx1[3] = x1 + ((x0 <= ix.primary && ix.primary < x0 + s) ? 1 : 0);
  nx1[2] = nx1[3] + ns[3];
  nx1[1] = nx1[2] + ns[2];
  nx1[0] = nx1[1] + ns[1];
}

// The forward extension of (x0, x1, s) by base c (P.c): the backward
// extension of the reverse complement by 3 - c, x0 and x1 swapped back.
template <class Tab>
__device__ __forceinline__ void extend_fwd1(const Tab& ix, int64_t x0,
                                            int64_t x1, int64_t s, int c,
                                            int64_t* ex0, int64_t* ex1,
                                            int64_t* es) {
  int64_t nx0[4], nx1[4], ns[4];
  extend_back4(ix, x1, x0, s, nx0, nx1, ns);
  *ex0 = nx1[3 - c];
  *ex1 = nx0[3 - c];
  *es = ns[3 - c];
}

// One call's emissions: field f of emission k at m[f * kMCap + k], fields
// qb, qe, x0, x1, s.
struct Smem1 {
  int64_t ret;
  bool ovf;
  int n;
};

// bwt_smem1 of read q (qlen bases, codes 0..3, N = 4) at x with the JAX
// program's caps: the SMEMs through x in emission order (qb descending)
// into m, the position the scan resumes at, and the overflow flag.  A read
// whose x is not a base (x >= qlen or an N) gives x + 1 and nothing.
template <class Tab>
__device__ inline Smem1 smem1_dev(const Tab& ix, const uint8_t* q,
                                  int64_t qlen, int64_t x, int64_t min_intv,
                                  int64_t* m) {
  Smem1 out{x + 1, false, 0};
  if (x < 0 || x >= qlen || q[x] > 3) return out;
  const int c0 = q[x];
  int64_t cx0 = ix.C[c0], cs = ix.C[c0 + 1] - ix.C[c0], cx1 = ix.C[3 - c0];
  int64_t cqe = x + 1;
  // the forward list, later the live (prev) list, field-major
  int64_t px0[kPCap], px1[kPCap], ps[kPCap], pqe[kPCap];
  int fn = 0;
  for (int64_t i = x + 1;; ++i) {
    const bool stop_here = i >= qlen || q[i] > 3;
    int64_t ex0 = 0, ex1 = 0, es = cs;
    if (!stop_here) extend_fwd1(ix, cx0, cx1, cs, q[i], &ex0, &ex1, &es);
    if (stop_here || es != cs) {  // push the current interval
      if (fn < kPCap) {
        px0[fn] = cx0;
        px1[fn] = cx1;
        ps[fn] = cs;
        pqe[fn] = cqe;
        ++fn;
      } else {
        out.ovf = true;
      }
      if (stop_here || es < min_intv) break;
    }
    cx0 = ex0;
    cx1 = ex1;
    cs = es;
    cqe = i + 1;
  }
  out.ret = pqe[fn - 1];
  for (int a = 0, b = fn - 1; a < b; ++a, --b) {  // longest first
    int64_t t;
    t = px0[a], px0[a] = px0[b], px0[b] = t;
    t = px1[a], px1[a] = px1[b], px1[b] = t;
    t = ps[a], ps[a] = ps[b], ps[b] = t;
    t = pqe[a], pqe[a] = pqe[b], pqe[b] = t;
  }
  int pn = fn, mn = 0;
  for (int64_t i = x - 1; i >= -1 && pn > 0; --i) {
    const int c = i >= 0 ? q[i] : 4;
    int ncnt = 0;
    bool tried = false;
    int64_t last_s = 0;
    for (int j = 0; j < pn; ++j) {
      int64_t nx0[4], nx1[4], ns[4];
      bool stop = c > 3;
      if (!stop) {
        extend_back4(ix, px0[j], px1[j], ps[j], nx0, nx1, ns);
        stop = ns[c] < min_intv;
      }
      if (stop) {
        // the first stopping slot before any kept one may emit
        if (ncnt == 0 && !tried) {
          tried = true;
          if ((mn == 0 || i + 1 < m[mn - 1]) && mn < kMCap) {
            m[0 * kMCap + mn] = i + 1;
            m[1 * kMCap + mn] = pqe[j];
            m[2 * kMCap + mn] = px0[j];
            m[3 * kMCap + mn] = px1[j];
            m[4 * kMCap + mn] = ps[j];
            ++mn;
          }
        }
      } else {
        // compacted in place: ncnt <= j, slot j is read before
        if (ncnt == 0 || ns[c] != last_s) {
          const int64_t qe = pqe[j];
          px0[ncnt] = nx0[c];
          px1[ncnt] = nx1[c];
          ps[ncnt] = ns[c];
          pqe[ncnt] = qe;
          ++ncnt;
        }
        last_s = ns[c];
      }
    }
    pn = ncnt;
  }
  out.n = mn;
  out.ovf = out.ovf || mn >= kMCap;
  return out;
}

// bwt_sa: the text position of SA row r by LF walks until the primary row
// or a sampled row; 0 if neither comes within max_it steps (never, for
// a well-formed index).
template <class Tab>
__device__ inline int64_t sa_value_dev(const Tab& ix, const int64_t* ssa,
                                       int64_t n_ssa, int64_t sa_intv,
                                       int64_t r, int64_t max_it) {
  for (int64_t d = 0; d < max_it; ++d) {
    if (r == ix.primary) return d;
    if (r % sa_intv == 0) return sample_at(ix, ssa, (r / sa_intv) % n_ssa) + d;
    const Block b = block_of(ix, r >> 6);
    const int off = (int)(r & 63), lane = 2 * (off & 15);
    const int sym = (int)((b.pk[off >> 4] >> lane) & 3u);
    const int vbit = (int)((b.va[off >> 4] >> lane) & 1u);
    int64_t rk[4];
    rank4(ix, r, rk);
    if (vbit)
      r = ix.C[sym] + rk[sym];
    else  // an N (the sentinel row is the primary, handled above)
      r = ix.C[4] + r - (rk[0] + rk[1] + rk[2] + rk[3]) -
          (r > ix.primary ? 1 : 0);
  }
  return 0;
}

}  // namespace fmseed
