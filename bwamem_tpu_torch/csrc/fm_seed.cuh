// FM-index seeding on the device: the __device__ functions of fm_seed.cu,
// templated on the table type.  The SMEM search runs a warp per read
// (smem1_warp: every lane runs the same loop, lane j holds live slot j);
// the SA walks and rank4 a thread per row.
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
//   the first stopping slot before any kept one (:248-286), which can only
//   be the first live slot.
// A read whose flag is set is searched again by the host's exact scalar
// smem1, as in the JAX package.
//
// The tables are the packed occ layout of index/occ_packed.py, interleaved
// into one 64-byte record a 64-symbol block (kRecWords int32 words): the
// four int32 checkpoints (occ), the four 32-bit words of 2-bit symbols
// (pk), the four words of 0b01 validity lanes (va), 16 bytes of padding;
// record nb holds occ's sentinel row (ops/smem_torch.py, block_records).
// A rank4 query or an LF step reads one record, 64-byte aligned: one line
// and one address translation, where three separate tables cost three.
// Everything else is integer work in registers.  Positions are int64.
// What bounds a read is its chain of dependent gathers, one rank4 pair an
// extension step: see fm_seed.cu.
//
// Two table types: Occ, the whole index on the thread's own card, and
// ShardedOcc, the index split by block range over up to kMaxShards cards
// (ops/smem_sharded.py).  They differ only in block_of (where a block's
// record lies) and sample_at (where a sampled-SA entry lies); the
// search, the walks and their caps are one code for both.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#ifdef __CUDACC__
// The lanes below this one (PTX %lanemask_lt).
__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}
#endif

namespace fmseed {

constexpr int kPCap = 24;     // live intervals of one call (P_CAP)
constexpr int kMCap = 64;     // SMEMs one call emits (M_CAP)
constexpr int kAllCap = 128;  // first-round SMEMs a read (ALL_CAP)
constexpr unsigned kFull = 0xffffffffu;  // every lane of the warp

constexpr int kRecWords = 16;  // int32 words of a block's record

struct Occ {
  const int32_t* rec;  // (nb + 1) x kRecWords: occ, pk, va, padding
  const int64_t* C;    // 6 entries
  int64_t primary;
  int64_t n_rows;
};

constexpr int kMaxShards = 8;  // BASELINE config #4: one host, 8 chips

// The tables split by contiguous 64-symbol block ranges (the layout of
// ShardedSeedTables in ops/smem_sharded.py): shard k holds the records of
// the global blocks [blk_origin + k*nb_loc, blk_origin + (k+1)*nb_loc),
// nb_loc records, and the sampled-SA entries [k*ns_loc, (k+1)*ns_loc).
// Each pointer is a device pointer on its shard's card; a thread reads the
// owner's memory directly (over NVLink, with peer access, when the owner is
// another card).  Passed to the kernels by value; every member is 8 bytes
// wide, so the ctypes mirror in ops/_build.py has no padding to match.
struct ShardedOcc {
  const int32_t* rec[kMaxShards];  // nb_loc x kRecWords a shard
  const int64_t* ssa[kMaxShards];  // ns_loc sampled-SA entries
  int64_t C[6];
  int64_t primary;
  int64_t n_rows;
  int64_t nb_loc;
  int64_t ns_loc;
  int64_t blk_origin;  // global block of shard 0's first record
  int64_t n_ssa;
  int64_t sa_intv;
  int64_t n_shards;
};

// The three rows of global block blk, in its record.
struct Block {
  const int32_t* occ;
  const uint32_t* pk;
  const uint32_t* va;
};

__device__ __forceinline__ Block record_rows(const int32_t* rec) {
  return Block{rec, reinterpret_cast<const uint32_t*>(rec + 4),
               reinterpret_cast<const uint32_t*>(rec + 8)};
}

__device__ __forceinline__ Block block_of(const Occ& ix, int64_t blk) {
  return record_rows(ix.rec + blk * kRecWords);
}

// The shard of entry g of a table split in runs of n_loc over n shards:
// the number of later shards whose first entry g reaches (compares, not a
// 64-bit division).
__device__ __forceinline__ int shard_of(int64_t g, int64_t n_loc,
                                        int64_t n) {
  int s = 0;
  for (int k = 1; k < kMaxShards; ++k) s += k < n && g >= k * n_loc;
  return s;
}

// The owning shard and the local record: the GPU counterpart of the JAX
// module's masked gather and psum (_rank4_partial, smem_sharded.py:186).
__device__ __forceinline__ Block block_of(const ShardedOcc& ix, int64_t blk) {
  const int64_t g = blk - ix.blk_origin;
  const int s = shard_of(g, ix.nb_loc, ix.n_shards);
  return record_rows(ix.rec[s] + (g - s * ix.nb_loc) * kRecWords);
}

// Sampled-SA entry k.
__device__ __forceinline__ int64_t sample_at(const Occ&, const int64_t* ssa,
                                             int64_t k) {
  return ssa[k];
}

__device__ __forceinline__ int64_t sample_at(const ShardedOcc& ix,
                                             const int64_t*, int64_t k) {
  const int s = shard_of(k, ix.ns_loc, ix.n_shards);
  return ix.ssa[s][k - s * ix.ns_loc];
}

// The three rows of a block, loaded whole: three 16-byte loads from one
// 64-byte record.
struct BlockRows {
  int4 occ;
  uint4 pk, va;
};

__device__ __forceinline__ BlockRows load_rows(const Block& b) {
  return BlockRows{*reinterpret_cast<const int4*>(b.occ),
                   *reinterpret_cast<const uint4*>(b.pk),
                   *reinterpret_cast<const uint4*>(b.va)};
}

// Counts of bases 0..3 in bwt[0:i) from the rows of i's block, r = i & 63.
__device__ __forceinline__ void rank4_rows(const BlockRows& b, int r,
                                           int64_t out[4]) {
  const uint32_t w[4] = {b.pk.x, b.pk.y, b.pk.z, b.pk.w};
  const uint32_t v[4] = {b.va.x, b.va.y, b.va.z, b.va.w};
  const int32_t base[4] = {b.occ.x, b.occ.y, b.occ.z, b.occ.w};
  uint32_t wk[4], vk[4];
  for (int k = 0; k < 4; ++k) {
    const int nsym = r - 16 * k;
    const uint32_t pmask = nsym >= 16 ? 0xFFFFFFFFu
                           : nsym <= 0 ? 0u
                                       : ((1u << (2 * nsym)) - 1u);
    wk[k] = w[k] & pmask;
    vk[k] = v[k] & pmask;
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

// Counts of bases 0..3 in bwt[0:i).
template <class Tab>
__device__ __forceinline__ void rank4(const Tab& ix, int64_t i,
                                      int64_t out[4]) {
  rank4_rows(load_rows(block_of(ix, i >> 6)), (int)(i & 63), out);
}

// The four backward extensions of (x0, x1, s) from the counts tk at x0
// and tl at x0 + s.
template <class Tab>
__device__ __forceinline__ void extend_from_ranks(
    const Tab& ix, int64_t x0, int64_t x1, int64_t s, const int64_t tk[4],
    const int64_t tl[4], int64_t nx0[4], int64_t nx1[4], int64_t ns[4]) {
  for (int c = 0; c < 4; ++c) {
    ns[c] = tl[c] - tk[c];
    nx0[c] = ix.C[c] + tk[c];
  }
  nx1[3] = x1 + ((x0 <= ix.primary && ix.primary < x0 + s) ? 1 : 0);
  nx1[2] = nx1[3] + ns[3];
  nx1[1] = nx1[2] + ns[2];
  nx1[0] = nx1[1] + ns[1];
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
  extend_from_ranks(ix, x0, x1, s, tk, tl, nx0, nx1, ns);
}

// v[c] for a c known only at run time, by selects: an array indexed by a
// register would live in local memory.
__device__ __forceinline__ int64_t pick(const int64_t v[4], int c) {
  return c == 0 ? v[0] : c == 1 ? v[1] : c == 2 ? v[2] : v[3];
}

// The backward extension of (x0, x1, s) by base c.
template <class Tab>
__device__ __forceinline__ void extend_back1(const Tab& ix, int64_t x0,
                                             int64_t x1, int64_t s, int c,
                                             int64_t* ex0, int64_t* ex1,
                                             int64_t* es) {
  int64_t nx0[4], nx1[4], ns[4];
  extend_back4(ix, x0, x1, s, nx0, nx1, ns);
  *ex0 = pick(nx0, c);
  *ex1 = pick(nx1, c);
  *es = pick(ns, c);
}

// The counts of bases 0..3 among the first nsym (1..16) symbols of the
// packed word w with validity lanes v, a byte a base.
__device__ __forceinline__ unsigned word_counts(uint32_t w, uint32_t v,
                                                int nsym) {
  const uint32_t pmask = nsym >= 16 ? 0xFFFFFFFFu : ((1u << (2 * nsym)) - 1u);
  unsigned packed = 0;
  for (int c = 0; c < 4; ++c) {
    const uint32_t t = ~(w ^ (0x55555555u * (uint32_t)c));
    packed |= (unsigned)__popc(t & (t >> 1) & 0x55555555u & v & pmask)
              << (8 * c);
  }
  return packed;
}

// The forward extension of (x0, x1, s) by base c (P.c): the backward
// extension of the reverse complement by 3 - c, x0 and x1 swapped back.
// Called by every lane of the warp with the same arguments.  Its two rank4
// queries go to each group of eight lanes: lane l counts word l & 3 of the
// block of x1 (l < 4) or of x1 + s (l >= 4), the four bases a byte each;
// two shuffles sum a query's words, and one a base trades the two
// queries' counts.  The card preferred this to a query a lane of a pair,
// and that to every lane issuing both (chip_tune.py --seed, PERF.md).
template <class Tab>
__device__ __forceinline__ void extend_fwd1_warp(const Tab& ix, int64_t x0,
                                                 int64_t x1, int64_t s,
                                                 int c, int64_t* ex0,
                                                 int64_t* ex1, int64_t* es) {
  const unsigned l = threadIdx.x & 7u;
  const bool hi = l & 4u;  // this lane counts at x1 + s
  const int k = (int)(l & 3u);
  const int64_t i = hi ? x1 + s : x1;
  const Block b = block_of(ix, i >> 6);
  const int nsym = (int)(i & 63) - 16 * k;
  unsigned packed = nsym > 0 ? word_counts(b.pk[k], b.va[k], nsym) : 0u;
  packed += __shfl_xor_sync(kFull, packed, 1);
  packed += __shfl_xor_sync(kFull, packed, 2);  // at most 64 a byte
  int64_t tk[4], tl[4], nx0[4], nx1[4], ns[4];
  for (int cc = 0; cc < 4; ++cc) {
    const int64_t mine = b.occ[cc] + (int64_t)((packed >> (8 * cc)) & 0xffu);
    const int64_t other = __shfl_xor_sync(kFull, mine, 4);
    tk[cc] = hi ? other : mine;
    tl[cc] = hi ? mine : other;
  }
  extend_from_ranks(ix, x1, x0, s, tk, tl, nx0, nx1, ns);
  *ex0 = pick(nx1, 3 - c);
  *ex1 = pick(nx0, 3 - c);
  *es = pick(ns, 3 - c);
}

// One call's emissions: field f of emission k at m[f * kMCap + k], fields
// qb, qe, x0, x1, s.
struct Smem1 {
  int64_t ret;
  bool ovf;
  int n;
};

// bwt_smem1 of read q (qlen bases, codes 0..3, N = 4) at x with the JAX
// program's caps, run by the 32 lanes of a warp together, each with the
// same arguments; every lane returns the same result: the SMEMs through x
// in emission order (qb descending) into m, the position the scan resumes
// at, and the overflow flag.  A read whose x is not a base (x >= qlen or
// an N) gives x + 1 and nothing.  Every branch that contains a warp
// collective is decided by values all lanes share.
//
// The forward pass is one chain of dependent steps that every lane runs,
// each step's two gathers split over eight lanes (extend_fwd1_warp).  Push
// k goes to lane kPCap-1-k, so the live lanes in ascending order hold the
// slots longest first, with no reversal.  The backward pass then extends every
// live slot at once (two rank4 gathers in flight a lane) and replaces the
// scalar slot loop with warp votes over the lanes; the slots stay in
// their lanes, a bit of `live` a slot, so nothing moves:
// - a slot goes on if its extension by q[i] has at least min_intv rows;
// - the first live slot, if it stops, may emit (the first stopping slot
//   before any kept one can only be the first live slot);
// - a slot that goes on is kept if it is the first to go on or its size
//   differs from that of the previous slot that goes on.
template <class Tab>
__device__ inline Smem1 smem1_warp(const Tab& ix, const uint8_t* q,
                                   int64_t qlen, int64_t x, int64_t min_intv,
                                   int64_t* m) {
  Smem1 out{x + 1, false, 0};
  if (x < 0 || x >= qlen || q[x] > 3) return out;
  const int lane = (int)(threadIdx.x & 31u);
  const int c0 = q[x];
  int64_t cx0 = ix.C[c0], cs = ix.C[c0 + 1] - ix.C[c0], cx1 = ix.C[3 - c0];
  int64_t cqe = x + 1;
  int64_t sx0 = 0, sx1 = 0, ss = 0, sqe = 0;  // this lane's slot
  int fn = 0;
  for (int64_t i = x + 1;; ++i) {
    const bool stop_here = i >= qlen || q[i] > 3;
    int64_t ex0 = 0, ex1 = 0, es = cs;
    if (!stop_here)
      extend_fwd1_warp(ix, cx0, cx1, cs, q[i], &ex0, &ex1, &es);
    if (stop_here || es != cs) {  // push the current interval
      if (fn < kPCap) {
        if (lane == kPCap - 1 - fn) {
          sx0 = cx0;
          sx1 = cx1;
          ss = cs;
          sqe = cqe;
        }
        out.ret = cqe;  // the qe of the last slot kept
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
  const unsigned below = lanemask_lt();
  unsigned live = ((1u << fn) - 1u) << (kPCap - fn);  // 1 <= fn <= kPCap
  int mn = 0;
  int64_t last_qb = 0;  // the qb of emission mn - 1
  for (int64_t i = x - 1; i >= -1 && live; --i) {
    const int c = i >= 0 ? q[i] : 4;
    int64_t nx0 = 0, nx1 = 0, ns = 0;
    bool go = false;
    if (c <= 3 && ((live >> lane) & 1u)) {
      extend_back1(ix, sx0, sx1, ss, c, &nx0, &nx1, &ns);
      go = ns >= min_intv;
    }
    const unsigned cont = __ballot_sync(kFull, go);
    const int first = __ffs(live) - 1;
    if (!((cont >> first) & 1u) && (mn == 0 || i + 1 < last_qb) &&
        mn < kMCap) {  // the first live slot stops and emits
      if (lane == first) {
        m[0 * kMCap + mn] = i + 1;
        m[1 * kMCap + mn] = sqe;
        m[2 * kMCap + mn] = sx0;
        m[3 * kMCap + mn] = sx1;
        m[4 * kMCap + mn] = ss;
      }
      last_qb = i + 1;
      ++mn;
    }
    const unsigned prev = cont & below;
    const int64_t prev_s =
        __shfl_sync(kFull, ns, prev ? 31 - __clz(prev) : lane);
    const bool keep = go && (prev == 0 || ns != prev_s);
    live = __ballot_sync(kFull, keep);
    if (keep) {
      sx0 = nx0;
      sx1 = nx1;
      ss = ns;
    }
  }
  out.n = mn;
  out.ovf = out.ovf || mn >= kMCap;
  return out;
}

// One LF step from row r (r != primary) with the rows b of r's block and
// C[0..4]: C[c] + the count of c in bwt[0:r) where r holds base c, and
// for an N (validity lane 0) C[4] + the rows before r that are N, less the
// primary row.  Only what the step needs is counted: the lanes of r's
// base before r, or every valid lane before r for an N (the four bases'
// counts summed, as each valid lane holds one base).
__device__ __forceinline__ int64_t lf_step(const BlockRows& b, int64_t r,
                                           int64_t primary,
                                           const int64_t C[5]) {
  const int off = (int)(r & 63), k = off >> 4, lane = 2 * (off & 15);
  const uint32_t w[4] = {b.pk.x, b.pk.y, b.pk.z, b.pk.w};
  const uint32_t v[4] = {b.va.x, b.va.y, b.va.z, b.va.w};
  const uint32_t wk = k == 0 ? w[0] : k == 1 ? w[1] : k == 2 ? w[2] : w[3];
  const uint32_t vk = k == 0 ? v[0] : k == 1 ? v[1] : k == 2 ? v[2] : v[3];
  const int sym = (int)((wk >> lane) & 3u);
  const bool valid = (vk >> lane) & 1u;
  const uint32_t pat = 0x55555555u * (uint32_t)sym;
  int cnt = 0;
  for (int j = 0; j < 4; ++j) {
    const int nsym = off - 16 * j;
    const uint32_t pmask = nsym >= 16 ? 0xFFFFFFFFu
                           : nsym <= 0 ? 0u
                                       : ((1u << (2 * nsym)) - 1u);
    const uint32_t t = ~(w[j] ^ pat);
    const uint32_t hit = valid ? t & (t >> 1) : 0xFFFFFFFFu;
    cnt += __popc(hit & 0x55555555u & v[j] & pmask);
  }
  if (valid) {
    const int32_t base = sym == 0 ? b.occ.x : sym == 1 ? b.occ.y
                         : sym == 2 ? b.occ.z : b.occ.w;
    return pick(C, sym) + base + cnt;
  }
  const int64_t all = (int64_t)b.occ.x + b.occ.y + b.occ.z + b.occ.w + cnt;
  return C[4] + r - all - (r > primary ? 1 : 0);
}

// bwt_sa: the text position of SA row r by LF walks until the primary row
// or a sampled row; 0 if neither comes within max_it steps (never, for
// a well-formed index).  sa_shift is log2(sa_intv) when sa_intv is a power
// of two (a mask and a shift find the sampled rows), -1 otherwise (a
// division a step); n_ssa covers every row, so the index into the sampled
// SA is reduced modulo n_ssa only where it reaches n_ssa (as the JAX
// program's modulo does).  A step reads one record.
template <class Tab>
__device__ inline int64_t sa_value_dev(const Tab& ix, const int64_t* ssa,
                                       int64_t n_ssa, int64_t sa_intv,
                                       int sa_shift, int64_t r,
                                       int64_t max_it) {
  const int64_t C[5] = {ix.C[0], ix.C[1], ix.C[2], ix.C[3], ix.C[4]};
  const int64_t primary = ix.primary;
  const bool pow2 = sa_shift >= 0;
  const int64_t low = pow2 ? ((int64_t)1 << sa_shift) - 1 : 0;
  for (int64_t d = 0; d < max_it; ++d) {
    if (r == primary) return d;
    const bool sampled = pow2 ? (r & low) == 0 : r % sa_intv == 0;
    if (sampled) {
      int64_t k = pow2 ? r >> sa_shift : r / sa_intv;
      if (k >= n_ssa) k %= n_ssa;
      return sample_at(ix, ssa, k) + d;
    }
    r = lf_step(load_rows(block_of(ix, r >> 6)), r, primary, C);
  }
  return 0;
}

}  // namespace fmseed
