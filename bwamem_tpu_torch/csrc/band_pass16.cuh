// The banded extension pass with packed 16-bit cells (the Pallas kernels'
// compute_dtype=jnp.int16, -/+2^14 sentinels): bwt_extend_t_i16 and
// bwt_extend_fused_i16.  band_pass.cuh includes this file after the
// 32-bit pass and the helpers both passes share; it is not included on its
// own.
//
// A register holds TWO query columns and the recurrence runs on both halves
// at once with Hopper's packed DPX instructions (__viaddmax_s16x2[_relu],
// __viaddmin_s16x2, __vimax3_s16x2, __vibmax_s16x2): a thread's strip of C
// columns is two half-strips, pair p holding column p in its low half and
// column p + C/2 in its high half, so the two serial F chains run side by
// side and the diagonal moves a whole register at a time.  The substitution
// scores of a pair are one prmt.b32.  The scan across strips, the
// reductions and the control flow are per row and stay in int32.  The pass
// equals the 32-bit one while no intermediate leaves the 16-bit range,
// which the wrapper (ops/extend_cuda.check_i16_range) enforces from host
// data.
//
// What bounds it: integer issue, and on small batches the spread of the
// lanes' lengths.  A pair costs about 32 instructions a row over its two
// cells (14 in the first sweep, 18 in the second), and each row of a group
// pays a fixed amount of int32 bookkeeping besides: the target base's
// shuffle, the F scan across the group, the diagonal's shuffle, four group
// reductions (the row maximum's key, H(i, endc-1), the first and the last
// non-zero column), the clamp, the Z-drop and the trim.  Run under the
// 32-bit launch table (a warp a lane up to 256 columns, 2-4 columns a
// thread), that bookkeeping outweighed the packed cells, and the packed
// kernels were slower than the 32-bit ones.  So:
// - The cells have a launch table of their own (BWT_LAUNCH_TABLE16 in
//   launch_table.cuh, dispatch_shape16), with even strips.  8-thread
//   groups with 14-20 columns a thread pay a row's bookkeeping over 3-5x
//   the cells, but a warp of four lanes runs until its longest ends: on
//   the lanes `mem` makes, whose lengths spread, they took 34-44% longer
//   in the fused kernel at 16,384 and 32,768 lanes, and below 16,384 in
//   either kernel, so from 65 columns up a lane keeps a whole warp.  The
//   lanes' spread also leaves SMs idle at the end of a launch that fits
//   in one wave, so a whole-warp launch is held to at least kWaves16
//   waves of blocks (residency_cap16).
// - A pair's band masks are two sign masks (outside [lo, hi) and outside
//   [lo, hi]), each an add, a packed add-min and one prmt.b32 that spreads
//   each half's sign over the half: no compare and no multiply.  In
//   registers they are made once a row, in the first sweep, and kept for
//   the second.
// - Out of the band M is 0, not a sentinel: every use of M passes through
//   a maximum with 0 or through the masks, so the first sweep's M, its
//   mask and its zero test (an integer add and a prmt.b32) are one LOP3,
//   and the new E carries the mask (0 out of the band and at its end)
//   into both the stored E and the non-zero bits of the trim.
// - The trim's bits cover column endc as well (its new H is H(i, endc-1),
//   its new E 0), so the trim needs no H(i, endc-1) of its own.
//
// Base codes are 0..3 with N = 4 (any code in 4..127 counts as N).

#pragma once

#include <mutex>

namespace {

constexpr unsigned kMin2 = 0x80008000u;  // -2^15 in both halves
constexpr unsigned kOne2 = 0x00010001u;

__device__ __forceinline__ unsigned pack2(int lo, int hi) {
  return ((unsigned)lo & 0xffffu) | ((unsigned)hi << 16);
}
// v in both halves (one prmt.b32: bytes 0, 1, 0, 1 of v)
__device__ __forceinline__ unsigned dup2(int v) {
  return prmt_b32((unsigned)v, 0u, 0x1010u);
}
__device__ __forceinline__ int lo16(unsigned v) { return (int)(short)v; }
__device__ __forceinline__ int hi16(unsigned v) { return (int)v >> 16; }
// per half: x where the half of m is 0xffff, y where it is 0
__device__ __forceinline__ unsigned sel2(unsigned m, unsigned x, unsigned y) {
  return (x & m) | (y & ~m);
}
// per half: a + b (one DPX instruction: max(a + b, -2^15))
__device__ __forceinline__ unsigned add2(unsigned a, unsigned b) {
  return __viaddmax_s16x2(a, b, kMin2);
}
// per half: 0xffff where the half of v is negative, else 0 (the sign of
// each half's high byte spread over its two bytes by one prmt.b32)
__device__ __forceinline__ unsigned neg2(unsigned v) {
  return prmt_b32(v, 0u, 0xBB99u);
}
// per half: 0xffff where the half of v (each in 0..2^15) is not 0: adding
// 2^15 - 1 sets bit 15 of exactly those halves and carries out of none,
// so one integer add and one prmt.b32
__device__ __forceinline__ unsigned nonzero2(unsigned v) {
  return neg2(v + 0x7fff7fffu);
}
// The selector that makes prmt.b32 of a row's score word give the scores
// of two query codes, sign-extended into the two halves.
__device__ __forceinline__ unsigned pair_selector(int c_lo, int c_hi) {
  c_lo = (unsigned)c_lo > 3u ? 4 : c_lo;
  c_hi = (unsigned)c_hi > 3u ? 4 : c_hi;
  return (unsigned)(c_lo | ((c_lo | 8) << 4) | (c_hi << 8) |
                    ((c_hi | 8) << 12));
}

// The strip of one thread in registers: C columns of H, E and the query
// (as score selectors), C / 2 registers of pairs.
template <int C>
struct RegRow<C, int16_t> {
  static_assert(C % 2 == 0 && C <= 32,
                "a packed strip holds whole pairs, at most 16 of them");
  using Cell = int16_t;
  static constexpr int kC = C;
  unsigned hv[C / 2], ev[C / 2], qv[C / 2];
  __device__ __forceinline__ int ncol() const { return C; }
  __device__ __forceinline__ unsigned h(int p) const { return hv[p]; }
  __device__ __forceinline__ unsigned e(int p) const { return ev[p]; }
  __device__ __forceinline__ unsigned q(int p) const { return qv[p]; }
  __device__ __forceinline__ void set_h(int p, unsigned v) { hv[p] = v; }
  __device__ __forceinline__ void set_e(int p, unsigned v) { ev[p] = v; }
  __device__ __forceinline__ void set_q(int p, unsigned v) { qv[p] = v; }
};

// The strip of one thread of a warp in shared memory: n / 2 pairs, pair p
// of thread k at word (halfword for the pair's selector) p*32 + k.
template <>
struct SmemRow<int16_t> {
  using Cell = int16_t;
  static constexpr int kC = 0;
  unsigned* hp;
  unsigned* ep;
  uint16_t* qp;
  int n;  // columns: twice the pairs
  __device__ __forceinline__ int ncol() const { return n; }
  __device__ __forceinline__ unsigned h(int p) const { return hp[p * 32]; }
  __device__ __forceinline__ unsigned e(int p) const { return ep[p * 32]; }
  __device__ __forceinline__ unsigned q(int p) const { return qp[p * 32]; }
  __device__ __forceinline__ void set_h(int p, unsigned v) { hp[p * 32] = v; }
  __device__ __forceinline__ void set_e(int p, unsigned v) { ep[p * 32] = v; }
  __device__ __forceinline__ void set_q(int p, unsigned v) {
    qp[p * 32] = (uint16_t)v;
  }
};

// The masks of pair p of a strip of np pairs, per half 0xffff or 0: o
// where the column c is outside the band [lo, hi), ow where it is outside
// [lo, hi] (the band and its end column).  nlo = dup2(-lo), hm1 =
// dup2(hi - 1): o is the sign of min(c - lo, hi - 1 - c), ow that of
// min(c - lo, hi - c).  Every term lies in -2048..2047.
__device__ __forceinline__ void pair_masks16(int p, int np, unsigned nlo,
                                             unsigned hm1, unsigned& o,
                                             unsigned& ow) {
  // (the constant second: the instruction's one immediate operand)
  const unsigned above = add2(nlo, pack2(p, p + np));      // c - lo
  const unsigned below = add2(hm1, pack2(-p, -p - np));    // hi - 1 - c
  o = neg2(__viaddmin_s16x2(below, 0u, above));
  ow = neg2(__viaddmin_s16x2(below, kOne2, above));
}

// The two sweeps of one row over a strip of int16_t cells, two columns a
// register: pair p holds strip column p (low half) and p + np (high
// half), so the strip is two half-strips whose F chains run side by side.
// Which ow a column gets when the band is empty does not matter: that
// row's maximum is 0 and the pass ends with it.  Leaves in key the maximum
// of H*1024 + j over the strip, in hl H(i, endc-1) where this strip holds
// column endc or endc is past the row (0 elsewhere), in first_nz the first
// in-band column whose new H or E is not 0 (kBig where there is none), and
// in last_nz the last column of [begc, endc] whose new H or E is not 0
// (begc - 1 where there is none): bwa's trim reads column endc too, whose
// new H is H(i, endc-1) and whose new E is 0, and endc is the row's end
// when it lies past the last strip.
template <int G, class Row>
__device__ __forceinline__ void sweep_row16(
    Row& row, unsigned sw, const Prm& p, int oe_ins, int oe_del, int lo,
    int hi, int tg, int j0, int h1_first, int begc, unsigned gmask, int& key,
    int& hl, int& first_nz, int& last_nz) {
  constexpr int kP = Row::kC > 0 ? Row::kC / 2 : 1;
  const int np = Row::kC > 0 ? Row::kC / 2 : row.ncol() / 2;
  const unsigned noe_ins = dup2(-oe_ins), noe_del = dup2(-oe_del);
  const unsigned ne_ins = dup2(-p.e_ins), ne_del = dup2(-p.e_del);
  const unsigned nlo = dup2(-lo), hm1 = dup2(hi - 1);
  // the pairs that this row can touch: the hull of the columns [lo, hi]
  // in the low half-strip and in the high one
  int p0 = 0, p1 = np;
  if constexpr (Row::kC == 0) {
    p0 = np;
    p1 = 0;
    const int la = imax(lo, 0), lb = imin(hi, np - 1);
    if (la <= lb) {
      p0 = la;
      p1 = lb + 1;
    }
    const int ha = imax(lo - np, 0), hb = imin(hi - np, np - 1);
    if (ha <= hb) {
      p0 = imin(p0, ha);
      p1 = imax(p1, hb + 1);
    }
  }
  unsigned ok[kP], owk[kP];  // the masks, kept from pass 1 in registers

  // pass 1: M replaces H(i-1, j-1) in the band, and the halves of f become
  // the F that leaves each half-strip when none enters it.  M is 0 where
  // H(i-1, j-1) is 0 and outside the band.
  unsigned f = 0;
#pragma unroll
  for (int pp = p0; pp < p1; ++pp) {
    unsigned o, ow;
    pair_masks16(pp, np, nlo, hm1, o, ow);
    if constexpr (Row::kC > 0) {
      ok[pp] = o;
      owk[pp] = ow;
    }
    const unsigned hv = row.h(pp);
    const unsigned sc = prmt_b32(sw, 0xffffffffu, row.q(pp));
    const unsigned M = add2(hv, sc) & nonzero2(hv) & ~o;
    row.set_h(pp, sel2(o, hv, M));
    f = __viaddmax_s16x2_relu(f, ne_ins, add2(M, noe_ins));
  }
  // the F entering the strip (the scan is per row: int32), and the F
  // entering its high half-strip
  const int f_lo = lo16(f), half_ins = p.e_ins * np;
  const int f_in = scan_f<G>(imax(hi16(f), f_lo - half_ins), 2 * half_ins,
                             tg, gmask);
  f = pack2(f_in, imax(f_lo, f_in - half_ins));

  // pass 2: H, its maximum with its pair number per half, the new E and
  // the diagonal for the next row
  unsigned prev = 0;      // the pair before: H(i, j-1), 0 outside the band
  unsigned hmax = 0;      // max of H per half
  int at_lo = 0, at_hi = 0;  // the last pair that reached it
  unsigned hl2 = 0;       // H(i, endc-1) in the half that owns column endc
  unsigned nz = 0;        // bit p (low half) and 16 + p (high half)
#pragma unroll
  for (int pp = p0; pp < p1; ++pp) {
    unsigned o, ow;
    if constexpr (Row::kC > 0) {
      o = ok[pp];
      ow = owk[pp];
    } else {
      pair_masks16(pp, np, nlo, hm1, o, ow);
    }
    const unsigned hv = row.h(pp);
    const unsigned M = hv & ~o;
    const unsigned e = row.e(pp);
    const unsigned h = __vimax3_s16x2(M, e, f) & ~o;
    f = __viaddmax_s16x2_relu(f, ne_ins, add2(M, noe_ins));
    bool ge_hi, ge_lo;
    hmax = __vibmax_s16x2(h, hmax, &ge_hi, &ge_lo);
    if (ge_lo) at_lo = pp;
    if (ge_hi) at_hi = pp;
    // 0 outside the band and at its end
    const unsigned en =
        __viaddmax_s16x2_relu(e, ne_del, add2(M, noe_del)) & ~o;
    row.set_e(pp, sel2(ow, e, en));
    if (pp > 0) {
      row.set_h(pp, sel2(ow, hv, prev));
      hl2 |= prev & o & ~ow;
      nz |= __vimin3_s16x2((prev | en) & ~ow, kOne2, kOne2) << pp;
    }
    prev = h;
  }
  // pair 0 takes its diagonals from the strip before (low half) and from
  // the end of the low half-strip (high half)
  const unsigned last = p1 == np ? prev : 0u;  // H of columns np-1, 2np-1
  const int last_lo = (int)(last & 0xffffu), last_hi = (int)(last >> 16);
  int up = __shfl_up_sync(gmask, last_hi, 1, G);
  if (tg == 0) up = h1_first;
  if (p0 == 0) {
    unsigned o, ow;
    if constexpr (Row::kC > 0) {
      o = ok[0];
      ow = owk[0];
    } else {
      pair_masks16(0, np, nlo, hm1, o, ow);
    }
    const unsigned h0new = pack2(up, last_lo);
    row.set_h(0, sel2(ow, row.h(0), h0new));
    hl2 |= h0new & o & ~ow;
    nz |= __vimin3_s16x2((h0new | row.e(0)) & ~ow, kOne2, kOne2);
  }
  hl = (int)((hl2 & 0xffffu) | (hl2 >> 16));  // one half at most is set
  const bool past = tg == G - 1 && hi == 2 * np;  // column endc past the row
  if (past) hl = last_hi;
  key = imax((int)((hmax & 0xffffu) << 10) + j0 + at_lo,
             (int)((hmax >> 16) << 10) + j0 + np + at_hi);
  // bit b of nz is strip column (b & 15) + (b < 16 ? 0 : np)
  const int b0 = __ffs(nz) - 1, b1 = 31 - __clz(nz);
  first_nz = nz ? j0 + (b0 & 15) + (b0 >> 4) * np : kBig;
  last_nz = nz ? j0 + (b1 & 15) + (b1 >> 4) * np : begc - 1;
  if (past && last_hi != 0) last_nz = j0 + 2 * np;
}

// band_pass for a row of packed int16_t cells: the same arguments, row
// bookkeeping (clamp, maxima, Z-drop, trim: per row, int32) and result,
// around sweep_row16.  It is a function of its own so that the 32-bit pass
// compiles to what it was before the cells had a type: folding the two
// into one template cost the 32-bit fused kernel 5-11%, and sharing only
// the end of the row (from the two reductions to the trim) as an inlined
// helper still 4-8% at the (160, 320) windows (chip_tune.py --against,
// H100 at 700 W).  A change to the Z-drop or trim rule goes into both
// passes; tests/test_torch_simt.py, tests/test_torch_simt16.py and
// chip_smoke.py hold each to the plain version.
template <int G, class Row>
__device__ __forceinline__ PassOut band_pass16(
    Row& row, const int8_t* __restrict__ q, int qmax,
    const int8_t* __restrict__ t, int tmax, int64_t B, int64_t lane, int qlen,
    int tlen, int w, int h0, bool run, const Prm& p, int tg) {
  PassOut r{h0, -1, -1, -1, -1, 0};
  if (!run || qlen <= 0 || tlen <= 0 || h0 <= 0) return r;
  if (qlen > qmax) qlen = qmax;  // memory safety; callers keep qlen <= qmax
  const unsigned gmask = group_mask<G>();
  const int oe_del = p.o_del + p.e_del;
  const int oe_ins = p.o_ins + p.e_ins;
  const int ncol = Row::kC > 0 ? Row::kC : row.ncol();
  const int j0 = tg * ncol;

  // the query strip, and the first (virtual) row: h0, h0 - oe_ins, then
  // decreasing by e_ins down to 0
  const int np = ncol / 2;
#pragma unroll
  for (int pp = 0; pp < np; ++pp) {
    int code[2], first[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int j = j0 + pp + k * np;
      code[k] = j < qlen ? q[(int64_t)j * B + lane] : 4;
      const int v = imax(h0 - oe_ins - (j - 1) * p.e_ins, 0);
      first[k] = j == 0 ? h0 : (j <= qlen ? v : 0);
    }
    row.set_q(pp, pair_selector(code[0], code[1]));
    row.set_h(pp, pack2(first[0], first[1]));
    row.set_e(pp, 0u);
  }

  int best = h0, max_i = -1, max_j = -1, max_ie = -1, gscore = -1;
  int max_off = 0;
  int beg = 0, end = qlen;
  bool live = true;
  for (int i0 = 0; live && i0 < tlen; i0 += G) {
    // the target bases of rows i0 .. i0+G-1, one per thread
    const int tchunk = t[(int64_t)imin(i0 + tg, tmax - 1) * B + lane];
    const int i_end = imin(i0 + G, tlen);
    for (int i = i0; i < i_end; ++i) {
      const int ti = __shfl_sync(gmask, tchunk, i - i0, G);
      const unsigned sw = score_word(ti, p.a, p.b);
      // band clamp
      const int begc = imax(beg, i - w);
      const int endc = imin(imin(end, i + w + 1), qlen);
      const int h1_first =
          begc == 0 ? imax(h0 - (p.o_del + p.e_del * (i + 1)), 0) : 0;
      const int lo = begc - j0, hi = endc - j0;  // in band: lo <= c < hi
      int key, hl;  // max of H*1024 + j; H(i, endc-1)
      // the first in-band column and the last column of [begc, endc]
      // whose new H or E is not 0
      int first_col, last_col;
      sweep_row16<G>(row, sw, p, oe_ins, oe_del, lo, hi, tg, j0, h1_first,
                     begc, gmask, key, hl, first_col, last_col);

      const int kmax = __reduce_max_sync(gmask, key);
      const int row_max = kmax >> 10, mj = kmax & 1023;
      int h1_last = __reduce_max_sync(gmask, hl);
      if (endc <= begc) h1_last = h1_first;
      if (endc == qlen) {
        if (!(gscore > h1_last)) max_ie = i;
        gscore = imax(gscore, h1_last);
      }
      if (row_max == 0) {
        live = false;
        break;
      }
      if (row_max > best) {
        best = row_max;
        max_i = i;
        max_j = mj;
        max_off = imax(max_off, mj >= i ? mj - i : i - mj);
      } else if (p.zdrop > 0) {
        const int di = i - max_i, dj = mj - max_j;
        const int pen = di > dj ? (di - dj) * p.e_del : (dj - di) * p.e_ins;
        if (best - row_max - pen > p.zdrop) {
          live = false;
          break;
        }
      }
      // two-sided zero-run band trim for the next row: its columns hold
      // column endc, so it needs no h1_last
      const int first_nz = __reduce_min_sync(gmask, first_col);
      const int last_nz = __reduce_max_sync(gmask, last_col);
      beg = imin(first_nz, endc);
      end = imin(last_nz + 2, qlen);
    }
  }
  r.best = best;
  r.max_j = max_j;
  r.max_i = max_i;
  r.max_ie = max_ie;
  r.gscore = gscore;
  r.max_off = max_off;
  return r;
}

// Dynamic shared-memory bytes that hold a 16-bit launch of `blocks` blocks
// of `kernel` in whole warps (G == 32, strips in registers, where a block
// needs no shared memory) to the residency that spreads them over at
// least kWaves16 waves of the card, or 0 where its registers already hold
// it there.  The lanes of a batch run for very different numbers of rows;
// in one wave each SM waits for its longest, while over more than one the
// block scheduler hands the SMs that finish early more blocks.  On the
// 16-bit path's `mem` batches (4,096 lanes) this cut the fused kernel's
// time by a sixth (chip_tune.py, PERF.md).
constexpr double kWaves16 = 1.6;

template <auto Kernel>
inline size_t residency_cap16(unsigned blocks) {
  struct Card {
    int sms = 0, smem_sm = 0, resident = 0;
  };
  constexpr int kCards = 64;
  // queried once a kernel and card: the launches of one process may run
  // on cards of different kinds
  static Card cards[kCards];
  static std::once_flag queried[kCards];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= kCards) return 0;
  std::call_once(queried[dev], [dev] {
    Card& c = cards[dev];
    cudaDeviceGetAttribute(&c.sms, cudaDevAttrMultiProcessorCount, dev);
    cudaDeviceGetAttribute(&c.smem_sm,
                           cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&c.resident, Kernel,
                                                  kThreads, 0);
  });
  const Card& card = cards[dev];
  const int k = (int)((blocks + kWaves16 * card.sms - 1) /
                      (kWaves16 * card.sms));
  if (k >= card.resident) return 0;
  // each block also takes 1 KB of the SM's shared memory for itself
  const size_t bytes = (size_t)(card.smem_sm / (k < 1 ? 1 : k)) - 1024;
  if (bytes > 48 * 1024) {  // above 48 KB only when asked for, per card
    cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)bytes);
  }
  return bytes;
}

// Calls fn.template run<G, C>() with the group width and strip length that
// BWT_LAUNCH_TABLE16 gives a query window of qmax columns with 16-bit
// cells (C even; above the last window, up to 1024 columns, C == 0: the
// shared-memory row of a whole warp, 2 * ceil(qmax / 64) columns a
// thread).  Returns what it returns, or cudaErrorInvalidValue above 1024
// columns.
template <class Fn>
inline int dispatch_shape16(int qmax, Fn&& fn) {
#define BWT_ROW16(QMAX, G, C)                                         \
  static_assert((C) % 2 == 0 && (G) * (C) >= (QMAX), "a 16-bit row"); \
  if (qmax <= QMAX) return fn.template run<G, C>();
  BWT_LAUNCH_TABLE16(BWT_ROW16)
#undef BWT_ROW16
  if (qmax <= 1024) return fn.template run<32, 0>();
  return (int)cudaErrorInvalidValue;
}

}  // namespace
