// One banded ksw_extend2 pass per group of cooperating threads, shared by
// the port's extension kernels (extend_fused.cu, extend_t.cu).
//
// It computes what the row function of the Pallas kernels' _band_pass in
// bwamem_tpu/ops/extend_pallas.py computes (and the plain PyTorch
// ops/extend_torch.band_pass, which is its specification row by row), laid
// out for Hopper instead of for the TPU's (sublane, lane) tiles:
//
// - A group of G threads (a warp, or an 8- or 16-thread tile of a warp
//   where the query window is short) runs one alignment.  Thread k of the
//   group owns the strip of query columns [k*C, (k+1)*C).
// - The H/E row never leaves the chip: it lives in registers where the
//   strip is short (RegRow, every loop over the strip fully unrolled) and
//   in shared memory where it is long (SmemRow, element (k, c) at word
//   c*32 + k, so a warp's accesses never share a bank).  The query strip is
//   loaded once per pass and kept beside it as byte-permute selectors, so
//   a cell's substitution score is one instruction; the target base of a
//   row is one byte of a G-row chunk that the group loads together and
//   broadcasts.
// - F is a scan, not a chain: each thread runs bwa's serial recurrence
//   f = max(f - e_ins, max(M - oe_ins, 0)) over its own strip from f = 0,
//   the values leaving the strips are combined across the group by a
//   log-step __shfl_up_sync prefix maximum (a strip boundary costs
//   e_ins * C), and the strip is run again from the F that enters it.
// - The diagonal H(i-1, j-1) crosses a strip's edge by one __shfl_up_sync.
// - The row maximum with its column is one __reduce_max_sync of the key
//   H*1024 + j (ties go to the larger j); the zero-run trim is a bit mask
//   per strip and one __reduce_min_sync / __reduce_max_sync; the band
//   clamp, the row_max == 0 break and the Z-drop are uniform across the
//   group, so the group never diverges.
//
// What bounds it is integer throughput (about 30 operations a cell
// against the 18 of the recurrence itself, plus the per-row reductions),
// not bytes: the windows are read once and nothing but the 8 result words
// per pass is written.
//
// Base codes are 0..3 with N = 4 (any code in 4..127 counts as N).  Each
// translation unit that includes this header gets its own copy of the
// device functions (no -rdc), so _build.py hashes headers with the sources.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "launch_table.cuh"

namespace {

constexpr int kThreads = 128;  // threads a block, every kernel and shape
constexpr int kBig = 1 << 29;

struct Prm {
  int a, b, o_del, e_del, o_ins, e_ins, zdrop;
};

struct PassOut {
  int best, max_j, max_i, max_ie, gscore, max_off;
};

__device__ __forceinline__ int imax(int x, int y) { return x > y ? x : y; }
__device__ __forceinline__ int imin(int x, int y) { return x < y ? x : y; }
// max(x, y, z) and max(x + y, z, 0): one DPX instruction each on sm_90
__device__ __forceinline__ int max3(int x, int y, int z) {
  return __vimax3_s32(x, y, z);
}
__device__ __forceinline__ int addmax_relu(int x, int y, int z) {
  return __viaddmax_s32_relu(x, y, z);
}

// The substitution score of a query base against the target base of a row
// is one byte permute.  score_word packs the row's scores of the query
// codes 0..3 into the four bytes of a word (all -1 where the target base
// is N); q_selector turns a query code into the selector that moves byte
// `code` of that word (byte 0 of the second operand, -1, for an N) into
// byte 0 and its sign into bytes 1..3; score_of applies it.  a and b must
// fit a signed byte.  prmt_b32(x, y, s) is PTX's prmt.b32 in its default
// mode, which the including source defines before this header
// (__byte_perm would not do: it passes on only 3 bits of each selector
// nibble, without the sign-replicating fourth).
__device__ __forceinline__ unsigned score_word(int ti, int a, int b) {
  const unsigned mis = (unsigned)(-b & 0xff) * 0x01010101u;
  return ti > 3 ? 0xffffffffu
                : mis ^ ((unsigned)((a ^ -b) & 0xff) << (8 * ti));
}
__device__ __forceinline__ int q_selector(int code) {
  code = (unsigned)code > 3u ? 4 : code;
  return code | ((code | 8) * 0x1110);
}
__device__ __forceinline__ int score_of(unsigned word, int selector) {
  return (int)prmt_b32(word, 0xffffffffu, (unsigned)selector);
}

// The strip of one thread in registers: C columns of H, E and the query
// (as score selectors).
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

// The strip of one thread of a warp in shared memory: n columns, element
// c of thread k at word (byte for the query) c*32 + k of the warp's slab.
struct SmemRow {
  static constexpr int kC = 0;
  int* hp;
  int* ep;
  int8_t* qp;
  int n;
  __device__ __forceinline__ int ncol() const { return n; }
  __device__ __forceinline__ int h(int c) const { return hp[c * 32]; }
  __device__ __forceinline__ int e(int c) const { return ep[c * 32]; }
  __device__ __forceinline__ int q(int c) const {
    return q_selector(qp[c * 32]);
  }
  __device__ __forceinline__ void set_h(int c, int v) { hp[c * 32] = v; }
  __device__ __forceinline__ void set_e(int c, int v) { ep[c * 32] = v; }
  __device__ __forceinline__ void set_q(int c, int v) {
    qp[c * 32] = (int8_t)(v & 7);  // the code is the selector's low bits
  }
};

// Shared-memory bytes a block of the SmemRow variant needs for strips of n
// columns: H and E words and the query byte of every column of every warp.
inline size_t smem_row_bytes(int n) {
  return (size_t)(kThreads / 32) * 32 * n * (2 * sizeof(int) + 1);
}

// The SmemRow of thread `tg` of warp `warp` of the block.
__device__ __forceinline__ SmemRow smem_row(unsigned char* base, int warp,
                                            int tg, int n) {
  const size_t words = (size_t)32 * n;
  int* ints = reinterpret_cast<int*>(base);
  SmemRow r;
  r.hp = ints + (size_t)warp * 2 * words + tg;
  r.ep = r.hp + words;
  r.qp = reinterpret_cast<int8_t*>(ints + (size_t)(kThreads / 32) * 2 * words)
         + (size_t)warp * words + tg;
  r.n = n;
  return r;
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

// One banded extension pass of alignment `lane` by the group of G threads
// that this thread is number `tg` of (ksw_extend_core).  Every argument
// but `row` and `tg` is uniform across the group, and so is the result.
// q is the (qmax, B) query window, t the (tmax, B) target window, both
// int8 base codes.  `run` false, or qlen/tlen/h0 <= 0, leaves the
// alignment untouched: best = h0, the rest of the fields at their initial
// values.  G * row.ncol() >= qmax.
template <int G, class Row>
__device__ __forceinline__ PassOut band_pass(
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
  const int strip_ins = p.e_ins * ncol;  // what F loses across one strip

  // the query strip, and the first (virtual) row: h0, h0 - oe_ins, then
  // decreasing by e_ins down to 0
#pragma unroll
  for (int c = 0; c < ncol; ++c) {
    const int j = j0 + c;
    row.set_q(c, q_selector(j < qlen ? q[(int64_t)j * B + lane] : 4));
    const int v = imax(h0 - oe_ins - (j - 1) * p.e_ins, 0);
    row.set_h(c, j == 0 ? h0 : (j <= qlen ? v : 0));
    row.set_e(c, 0);
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
      // the strip's columns that this row can touch: [lo, hi]
      const int c0 = Row::kC > 0 ? 0 : imax(lo, 0);
      const int c1 = Row::kC > 0 ? Row::kC : imin(hi + 1, ncol);

      // pass 1 over the strip: M replaces H(i-1, j-1) in the row (every
      // in-band column is rewritten below), and f becomes the F that leaves
      // the strip when none enters it
      int f = 0;
#pragma unroll
      for (int c = c0; c < c1; ++c) {
        const bool inb = c >= lo && c < hi;
        const int hv = row.h(c);
        const int M = hv ? hv + score_of(sw, row.q(c)) : 0;
        if (inb) row.set_h(c, M);
        f = addmax_relu(f, -p.e_ins, inb ? M - oe_ins : -kBig);
      }
      // F entering each strip: an exclusive prefix maximum across the group
      // of the F leaving the strips before it, each less its distance
      int v = f + strip_ins * tg;
#pragma unroll
      for (int d = 1; d < G; d <<= 1) {
        // (a thread with none d below it gets its own value back)
        v = imax(v, __shfl_up_sync(gmask, v, d, G));
      }
      v = __shfl_up_sync(gmask, v, 1, G);
      f = tg == 0 ? 0 : imax(v - strip_ins * (tg - 1), 0);

      // pass 2 over the strip: H, the row maximum, the new E and the
      // diagonal for the next row
      int prev = 0;       // H(i, j-1), 0 outside the band
      int key = 0;        // max of H*1024 + j
      int hl = 0;         // H(i, endc-1), seen by the owner of column endc
      unsigned nz = 0;    // in-band columns whose new H or E is not 0
#pragma unroll
      for (int c = c0; c < c1; ++c) {
        const bool inb = c >= lo && c < hi;
        const bool at_end = c == hi;
        const int M = inb ? row.h(c) : -kBig;
        const int e = row.e(c);
        const int h = inb ? max3(M, e, f) : 0;
        f = addmax_relu(f, -p.e_ins, M - oe_ins);
        key = imax(key, (h << 10) + j0 + c);
        const int en = at_end ? 0 : addmax_relu(e, -p.e_del, M - oe_del);
        if (inb || at_end) {
          row.set_e(c, en);
          if (c > 0) row.set_h(c, prev);
        }
        if (c > 0) {
          if (at_end) hl = prev;
          if (inb && (prev != 0 || en != 0)) nz |= 1u << c;
        }
        prev = h;
      }
      // column 0 of the strip takes its diagonal from the strip before
      const int last = c1 == ncol ? prev : 0;
      int up = __shfl_up_sync(gmask, last, 1, G);
      if (tg == 0) up = h1_first;
      if (lo <= 0 && hi >= 0) {
        row.set_h(0, up);
        if (hi == 0) hl = up;
        if (hi > 0 && (up != 0 || row.e(0) != 0)) nz |= 1u;
      }
      if (tg == G - 1 && hi == ncol) hl = last;  // column endc is past the row

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
      // two-sided zero-run band trim for the next row
      const int first_nz =
          __reduce_min_sync(gmask, nz ? j0 + __ffs(nz) - 1 : kBig);
      const int last_in =
          __reduce_max_sync(gmask, nz ? j0 + 31 - __clz(nz) : begc - 1);
      const int last_nz = imax(last_in, h1_last != 0 ? endc : begc - 1);
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

// The 8 output rows of one pass from row `row0` of `out` (rows, B):
// [score, qle, tle, gtle, gscore, max_off, aw, 0].
__device__ __forceinline__ void emit(int* out, int64_t B, int64_t lane,
                                     int row0, const PassOut& r, int aw) {
  int* o = out + (int64_t)row0 * B + lane;
  o[0] = r.best;
  o[B] = r.max_j + 1;
  o[2 * B] = r.max_i + 1;
  o[3 * B] = r.max_ie + 1;
  o[4 * B] = r.gscore;
  o[5 * B] = r.max_off;
  o[6 * B] = aw;
  o[7 * B] = 0;
}

// The row of thread `tg` for a strip of C columns in registers, or for
// C == 0 the shared-memory row of `ncol` columns in the block's `smem`.
template <int C>
__device__ __forceinline__ auto make_row(unsigned char* smem, int tg,
                                         int ncol) {
  if constexpr (C > 0) {
    return RegRow<C>{};
  } else {
    return smem_row(smem, threadIdx.x / 32, tg, ncol);
  }
}

// The body of the per-phase kernel for this thread: one pass of alignment
// `lane` = block * groups-per-block + group, scal (8, B) = [qlen, tlen,
// aw, h0, 0...], out (8, B).  `smem` is the block's dynamic shared memory
// (read only when C == 0).
template <int G, int C>
__device__ __forceinline__ void extend_t_body(
    const int8_t* __restrict__ q, int qmax, const int8_t* __restrict__ t,
    int tmax, const int32_t* __restrict__ scal, int64_t B, const Prm& p,
    int* __restrict__ out, int ncol, unsigned char* smem) {
  const int tg = threadIdx.x & (G - 1);
  const int64_t lane =
      (int64_t)blockIdx.x * (kThreads / G) + threadIdx.x / G;
  if (lane >= B) return;
  const int qlen = scal[0 * B + lane], tlen = scal[1 * B + lane];
  const int aw = scal[2 * B + lane], h0 = scal[3 * B + lane];
  auto row = make_row<C>(smem, tg, ncol);
  const PassOut r = band_pass<G>(row, q, qmax, t, tmax, B, lane, qlen, tlen,
                                 aw, h0, true, p, tg);
  if (tg == 0) emit(out, B, lane, 0, r, aw);
}

// The body of the fused kernel for this thread: passes 0..3 = L0, L1, R0,
// R1 of alignment `lane` as one loop around one copy of the pass.  A retry
// runs where the pass before it did not converge (max_off >= (w>>1) +
// (w>>2)), and the right side starts from the left score (alignments with
// no left task fall through to h0_seed: best = h0).  scal (16, B) rows
// [0]=qlen_l [1]=tlen_l [2]=aw0_l [3]=h0_seed [4]=aw1_l [5]=qlen_r
// [6]=tlen_r [7]=aw0_r [8]=aw1_r [9]=w; out (32, B).
template <int G, int C>
__device__ __forceinline__ void extend_fused_body(
    const int8_t* __restrict__ ql, int QL, const int8_t* __restrict__ tl,
    int TL, const int8_t* __restrict__ qr, int QR,
    const int8_t* __restrict__ tr, int TR, const int32_t* __restrict__ scal,
    int64_t B, const Prm& p, int* __restrict__ out, int ncol,
    unsigned char* smem) {
  const int tg = threadIdx.x & (G - 1);
  const int64_t lane =
      (int64_t)blockIdx.x * (kThreads / G) + threadIdx.x / G;
  if (lane >= B) return;
  const int w = scal[9 * B + lane];
  const int thr = (w >> 1) + (w >> 2);
  auto row = make_row<C>(smem, tg, ncol);
  int h0 = scal[3 * B + lane];
  int first_best = 0;
  bool conv = false;
#pragma unroll 1
  for (int k = 0; k < 4; ++k) {
    const bool right = k >= 2, retry = k & 1;
    const int qlen = scal[(right ? 5 : 0) * B + lane];
    const int tlen = scal[(right ? 6 : 1) * B + lane];
    const int aw = scal[(right ? 7 + retry : (retry ? 4 : 2)) * B + lane];
    const PassOut r = band_pass<G>(
        row, right ? qr : ql, right ? QR : QL, right ? tr : tl,
        right ? TR : TL, B, lane, qlen, tlen, aw, h0, !(retry && conv), p,
        tg);
    if (tg == 0) emit(out, B, lane, 8 * k, r, aw);
    if (!retry) {
      conv = r.max_off < thr;
      first_best = r.best;
    } else if (!right) {
      h0 = conv ? first_best : r.best;
    }
  }
}

// Blocks and dynamic shared-memory bytes of a launch over B alignments
// with groups of G threads and strips of `ncol` columns.
template <int G, int C>
inline void launch_shape(int64_t B, int qmax, unsigned* blocks, int* ncol,
                         size_t* smem) {
  const int per_block = kThreads / G;
  *blocks = (unsigned)((B + per_block - 1) / per_block);
  *ncol = C > 0 ? C : (qmax + 31) / 32;
  *smem = C > 0 ? 0 : smem_row_bytes(*ncol);
}

// Calls fn.template run<G, C>() with the group width and strip length that
// launch_table.cuh gives a query window of qmax columns (C == 0 is the
// shared-memory row of a whole warp, ceil(qmax / 32) columns a thread).
// Returns what it returns, or cudaErrorInvalidValue above 1024 columns.
template <class Fn>
inline int dispatch_shape(int qmax, Fn&& fn) {
#define BWT_ROW(QMAX, G, C) \
  if (qmax <= QMAX) return fn.template run<G, C>();
  BWT_LAUNCH_TABLE(BWT_ROW)
#undef BWT_ROW
  if (qmax <= 1024) return fn.template run<32, 0>();
  return (int)cudaErrorInvalidValue;
}

}  // namespace
