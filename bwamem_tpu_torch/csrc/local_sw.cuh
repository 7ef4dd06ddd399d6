// The whole ksw_align of a mate-rescue wave, one task per group of
// threads: the body of local_sw.cu's kernel (bwt_local_align6).
//
// It computes what the JAX package's one compiled program
// bwamem_tpu/ops/local_jax._align6 computes (and the plain PyTorch
// ops/local_torch.align6, its specification row by row): per task the
// forward local fill, the fill of the reversed prefixes (for qb, tb), and
// KSW_XSUBO's second best.  Inputs: query (B, qmax), target (B, tmax) int32
// base codes (target codes clamped to 0..4), qlen, tlen (B,), mat (5, 5),
// pens [o_del, e_del, o_ins, e_ins], all int32 on the card; out (6, B)
// int32 rows [score, qb, qe, tb, te, score2].
//
// The fill is ksw_extend2's recurrence without band, h0 or Z-drop, over
// the strips of sw_rows.cuh.  A row i:
// - pass 1 over the strip: M = H(i-1, j-1) + mat[t_i][q_j] (an arbitrary
//   matrix of int32: one load from a 100-byte table that stays in L1), Hd =
//   max(M, E, 0), 0 past qlen; the diagonal crosses a strip's edge by one
//   __shfl_up_sync;
// - F(j) = max(0, max_{j'<j} (Hd(j') + e_ins*j') - oe_ins - e_ins*(j-1)):
//   the strip's maximum of the ramped Hd, an exclusive prefix maximum of
//   those across the group, then pass 2 runs the maximum on along the strip;
// - pass 2: H = max(Hd, F), E = max(E - e_del, H - oe_del, 0);
// - the row's best: one __reduce_max_sync; only where it beats the best so
//   far (strictly: the first such row wins) one __reduce_min_sync of the
//   columns that hold it (the leftmost wins).
// Each row's best goes to the group's slot of scratch, written and later
// read by the thread i % G, so no thread reads another's write; score2 is
// the maximum over the rows at least max(qlen/2, 1) from the best row.  The
// second fill reads the query and the target backwards from qe and te, so
// no reversed copy is made.
//
// What bounds it is integer throughput: about 20 operations a cell against
// the 18 of the recurrence, plus per row a target-base shuffle, the
// diagonal shuffle, a log2(G)-step scan and a reduction.

#pragma once

#include "sw_rows.cuh"

namespace sw {

constexpr int kNegB = -(1 << 28);   // local_torch._NEGB

struct Pens {
  int o_del, e_del, o_ins, e_ins;
};

__device__ __forceinline__ Pens load_pens(const int32_t* pens) {
  return Pens{pens[0], pens[1], pens[2], pens[3]};
}

struct LocalBest {
  int best, bi, bj;
};

// One local fill of a task (local_torch.fill) by the group of G threads
// that this thread is number tg of.  qr and tr are the task's rows of the
// query and target; the fill runs over qlen columns and tlen rows (both
// already clamped to the windows), reading both backwards from qlen - 1
// and tlen - 1 when `rev`.  With row_best, the best of row i goes to
// row_best[i] (by thread i % G).  Uniform across the group.
template <int G, class Row>
__device__ __forceinline__ LocalBest local_fill(
    Row& row, const int32_t* __restrict__ qr, const int32_t* __restrict__ tr,
    int qlen, int tlen, bool rev, const int32_t* __restrict__ mat,
    const Pens& p, int tg, int32_t* row_best) {
  const unsigned gmask = group_mask<G>();
  const int ncol = Row::kC > 0 ? Row::kC : row.ncol();
  const int j0 = tg * ncol;
  const int oe_del = p.o_del + p.e_del, oe_ins = p.o_ins + p.e_ins;
#pragma unroll
  for (int c = 0; c < ncol; ++c) {
    const int j = j0 + c;
    row.set_q(c, j < qlen ? code04(qr[rev ? qlen - 1 - j : j]) : 4);
    row.set_h(c, 0);
    row.set_e(c, 0);
  }
  LocalBest b{0, -1, -1};
  for (int i0 = 0; i0 < tlen; i0 += G) {
    // the target bases of rows i0 .. i0+G-1, one a thread
    const int ii = i0 + tg;
    const int tchunk = ii < tlen ? tr[rev ? tlen - 1 - ii : ii] : 0;
    const int i_end = imin(i0 + G, tlen);
    for (int i = i0; i < i_end; ++i) {
      const int32_t* mrow =
          mat + 5 * code04(__shfl_sync(gmask, tchunk, i - i0, G));
      // H(i-1, j0-1), the diagonal of the strip's first column
      int diag = __shfl_up_sync(gmask, row.h(ncol - 1), 1, G);
      if (tg == 0) diag = 0;
      // pass 1: Hd replaces H(i-1, j) in the row
      int smax = kNegB;
#pragma unroll
      for (int c = 0; c < ncol; ++c) {
        const int j = j0 + c;
        const int hv = row.h(c);
        const int M = diag + mrow[row.q(c)];
        const int hd = j < qlen ? imax(imax(M, row.e(c)), 0) : 0;
        row.set_h(c, hd);
        smax = imax(smax, j < qlen ? hd + p.e_ins * j : kNegB);
        diag = hv;
      }
      int s = exclusive_max<G>(smax, tg, gmask, kNegB);
      // pass 2: H, E and the strip's best with its leftmost column
      int tmx = -1, tcol = 0;
#pragma unroll
      for (int c = 0; c < ncol; ++c) {
        const int j = j0 + c;
        const int hd = row.h(c);
        const int f = j == 0 ? 0 : imax(s - oe_ins - p.e_ins * (j - 1), 0);
        const int h = j < qlen ? imax(hd, f) : 0;
        s = imax(s, j < qlen ? hd + p.e_ins * j : kNegB);
        row.set_e(c, imax(imax(row.e(c) - p.e_del, h - oe_del), 0));
        row.set_h(c, h);
        if (j < qlen && h > tmx) {
          tmx = h;
          tcol = j;
        }
      }
      const int rb = imax(__reduce_max_sync(gmask, tmx), 0);
      if (row_best != nullptr && i - i0 == tg) row_best[i] = rb;
      if (rb > b.best) {
        b.bj = __reduce_min_sync(gmask, tmx == rb ? tcol : 0x7fffffff);
        b.best = rb;
        b.bi = i;
      }
    }
  }
  return b;
}

// The kernel body for this thread: every task lane = group, group +
// groups, ... of the launch.  `scratch` holds a slot of slot_bytes a
// group: the row bests (tmax int32), then the memory row where C == 0.
template <int G, int C>
__device__ __forceinline__ void local_align6_body(
    const int32_t* __restrict__ q, int qmax, const int32_t* __restrict__ qlen,
    const int32_t* __restrict__ t, int tmax, const int32_t* __restrict__ tlen,
    int64_t B, const int32_t* __restrict__ mat,
    const int32_t* __restrict__ pens, int32_t* __restrict__ out,
    unsigned char* scratch, int64_t slot_bytes) {
  const GroupIdx<G> gi = group_idx<G>();
  const int tg = gi.tg;
  const int ncol = strip_cols<G, C>(qmax);
  unsigned char* slot = scratch + gi.group * slot_bytes;
  int32_t* row_best = reinterpret_cast<int32_t*>(slot);
  auto row = make_row<G, C>(slot + ((int64_t)tmax * 4 + 15) / 16 * 16, tg,
                            ncol);
  const Pens p = load_pens(pens);
  for (int64_t lane = gi.group; lane < B; lane += gi.groups) {
    const int ql = qlen[lane], tl = tlen[lane];
    const int qn = imin(imax(ql, 0), qmax), tn = imin(imax(tl, 0), tmax);
    const int32_t* qr = q + lane * qmax;
    const int32_t* tr = t + lane * tmax;
    const LocalBest f =
        local_fill<G>(row, qr, tr, qn, tn, false, mat, p, tg, row_best);
    const int qe = f.bj + 1, te = f.bi + 1;
    const LocalBest r =
        local_fill<G>(row, qr, tr, qe, te, true, mat, p, tg, nullptr);
    // KSW_XSUBO: the best row at least half the query from the best row
    const int half = imax(ql / 2, 1);
    int s2 = 0;
    for (int i = tg; i < tn; i += G) {
      const int d = i - f.bi;
      if ((d < 0 ? -d : d) >= half) s2 = imax(s2, row_best[i]);
    }
    s2 = __reduce_max_sync(group_mask<G>(), s2);
    if (tg == 0) {
      int32_t* o = out + lane;
      o[0] = f.best;
      o[B] = qe - (r.bj + 1);
      o[2 * B] = qe;
      o[3 * B] = te - (r.bi + 1);
      o[4 * B] = te;
      o[5 * B] = s2;
    }
  }
}

// A group's slot: the row bests, then the memory row.
template <int G, int C>
inline int64_t local_slot_bytes(int qmax, int tmax) {
  return ((int64_t)tmax * 4 + 15) / 16 * 16 + mem_row_bytes<G, C>(qmax);
}

}  // namespace sw
