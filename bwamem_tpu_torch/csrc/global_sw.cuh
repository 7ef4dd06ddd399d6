// The banded global alignment with traceback of a CIGAR round, one task per
// group of threads: the body of global_sw.cu's kernel (bwt_global_cigar).
//
// It computes what the JAX package's one compiled program
// bwamem_tpu/ops/global_jax._global_batch computes (and the plain PyTorch
// ops/global_torch.global_batch, its specification row by row): bwa's
// ksw_global2 fill with its 6-bit z codes, then the traceback.  Inputs:
// query (B, qmax), target (B, tmax) int32 base codes (target codes clamped
// to 0..4), qlen, tlen, w (B,), mat (5, 5), pens [o_del, e_del, o_ins,
// e_ins], all int32 on the card.  Outputs: score (B,) int32 = H(tlen-1,
// qlen-1) and steps (qmax + tmax, B) int8, the step-ops in ksw's `which`
// coding back to front (0=M 1=D 2=I 3=done).
//
// The fill runs the rows of the task over the strips of sw_rows.cuh, the
// columns of the band [max(i-w, 0), min(i+w+1, qlen)) written, the others
// left as they are (w = max(w, |tlen - qlen|)).  The row state is ksw's
// eh_h / eh_e: column j of the strip holds eh_h[j+1] and eh_e[j], eh_h[0]
// (the left edge) is one value a group.  A row i:
// - pass 1: M = eh_h[j] + mat[t_i][q_j], kept in the row for the band's
//   columns; the strip's maximum of A = M + e_ins*j in the band and NEG
//   outside it;
// - F(j) = max_{j'<j} A(j') - oe_ins - e_ins*(j-1), F(0) = NEG: an
//   exclusive prefix maximum across the group, run on along the strip;
// - pass 2, in the band: the z code (H direction in bits 0-1, 0x04 "E goes
//   on", 0x20 "F goes on", E and F opening from M), H, E; eh_h[0] = the
//   left edge -(o_del + e_del*(i+1)) while beg == 0.
// All of it is plain int32 arithmetic around NEG = -(1 << 28), as in the
// plain version.  The z codes go to the group's slot, a (tmax, qmax) byte
// plane with 64-bit offsets, written only in the band; the traceback reads
// a cell outside the band as 0, as the plain version's zero-filled volume
// gives.  After a __syncwarp, thread 0 of the group walks the traceback:
// which = (z >> (which << 1)) & 3, the D/I tail after either edge, then 3
// to the end of the steps.

#pragma once

#include "local_sw.cuh"

namespace sw {

constexpr int kNeg = -(1 << 28);        // pipeline/cigar.NEG_INF
constexpr int kScanNone = -(1 << 30);   // below every A of a task

// Fill and traceback of one task by the group of G threads that this
// thread is number tg of.  qr and tr are the task's rows of the query and
// target; z is the group's (tmax, qmax) byte plane.  Returns the score
// (uniform across the group); thread 0 writes the steps at steps[s*B].
template <int G, class Row>
__device__ __forceinline__ int global_task(
    Row& row, const int32_t* __restrict__ qr, int qmax,
    const int32_t* __restrict__ tr, int tmax, int qlen, int tlen, int w,
    const int32_t* __restrict__ mat, const Pens& p, int tg, uint8_t* z,
    int8_t* steps, int64_t B) {
  const unsigned gmask = group_mask<G>();
  const int ncol = Row::kC > 0 ? Row::kC : row.ncol();
  const int j0 = tg * ncol;
  const int oe_del = p.o_del + p.e_del, oe_ins = p.o_ins + p.e_ins;
  {
    const int d = tlen - qlen;
    w = imax(w, d < 0 ? -d : d);
  }
  const int qn = imin(imax(qlen, 0), qmax), tn = imin(imax(tlen, 0), tmax);
  // the first row: eh_h[j] = -(o_ins + e_ins*j) for 1 <= j <= min(w,
  // qlen), NEG past it; eh_h[0] = 0; eh_e = NEG
  const int first = imin(w, qlen);
#pragma unroll
  for (int c = 0; c < ncol; ++c) {
    const int j = j0 + c;
    row.set_q(c, j < qn ? code04(qr[j]) : 4);
    row.set_h(c, j + 1 <= first ? -(p.o_ins + p.e_ins * (j + 1)) : kNeg);
    row.set_e(c, kNeg);
  }
  int hleft = 0;  // eh_h[0]
  for (int i0 = 0; i0 < tn; i0 += G) {
    const int ii = i0 + tg;
    const int tchunk = ii < tn ? tr[ii] : 0;
    const int i_end = imin(i0 + G, tn);
    for (int i = i0; i < i_end; ++i) {
      const int32_t* mrow =
          mat + 5 * code04(__shfl_sync(gmask, tchunk, i - i0, G));
      const int beg = imax(i - w, 0), end = imin(i + w + 1, qn);
      // eh_h[j0], the diagonal of the strip's first column
      int diag = __shfl_up_sync(gmask, row.h(ncol - 1), 1, G);
      if (tg == 0) diag = hleft;
      // pass 1: M replaces eh_h[j+1] in the band's columns
      int smax = kScanNone;
#pragma unroll
      for (int c = 0; c < ncol; ++c) {
        const int j = j0 + c;
        const bool inb = j >= beg && j < end;
        const int hv = row.h(c);
        const int m = diag + mrow[row.q(c)];
        if (inb) row.set_h(c, m);
        smax = imax(smax, inb ? m + p.e_ins * j : kNeg);
        diag = hv;
      }
      int s = exclusive_max<G>(smax, tg, gmask, kScanNone);
      // pass 2
      uint8_t* zrow = z + (int64_t)i * qmax;
#pragma unroll
      for (int c = 0; c < ncol; ++c) {
        const int j = j0 + c;
        const bool inb = j >= beg && j < end;
        const int f = j == 0 ? kNeg : s - oe_ins - p.e_ins * (j - 1);
        if (inb) {
          const int m = row.h(c), e = row.e(c);
          s = imax(s, m + p.e_ins * j);
          int d = m < e ? 1 : 0;
          const int hme = imax(m, e);
          if (f > hme) d = 2;
          if (e - p.e_del > m - oe_del) d |= 0x04;
          if (f - p.e_ins > m - oe_ins) d |= 0x20;
          zrow[j] = (uint8_t)d;
          row.set_h(c, imax(hme, f));
          row.set_e(c, imax(e - p.e_del, m - oe_del));
        } else {
          s = imax(s, kNeg);
        }
      }
      // ksw's eh_h[beg] = NEG (beg > 0) and eh_e[end] = NEG are not
      // written: the band only moves right, so eh_h[beg] is never read
      // again and eh_e[end] still holds its first NEG
      if (beg == 0) hleft = -(p.o_del + p.e_del * (i + 1));
    }
  }
  // the score, eh_h[qlen], from the thread that owns column qlen - 1
  int score = hleft;
  if (qn > 0) {
    int mine = 0;
#pragma unroll
    for (int c = 0; c < ncol; ++c)
      if (j0 + c == qn - 1) mine = row.h(c);
    score = __shfl_sync(gmask, mine, (qn - 1) / ncol, G);
  }
  __syncwarp(gmask);  // the z codes of every thread, for thread 0
  if (tg == 0) {
    int i = tn - 1, k = qn - 1, which = 0;
    const int smax = qmax + tmax;
    for (int st = 0; st < smax; ++st) {
      int op;
      if (i >= 0 && k >= 0) {
        const bool inb = k >= imax(i - w, 0) && k < imin(i + w + 1, qn);
        const int zv = inb ? z[(int64_t)i * qmax + k] : 0;
        op = (zv >> (which << 1)) & 3;
        which = op;
      } else {
        op = i >= 0 ? 1 : (k >= 0 ? 2 : 3);
      }
      i -= op == 0 || op == 1;
      k -= op == 0 || op == 2;
      steps[st * B] = (int8_t)op;
    }
  }
  __syncwarp(gmask);  // the plane is free for the group's next task
  return score;
}

// The kernel body for this thread: every task lane = group, group +
// groups, ... of the launch.  `scratch` holds a slot of slot_bytes a
// group: the z plane (tmax * qmax bytes), then the memory row where C == 0.
template <int G, int C>
__device__ __forceinline__ void global_cigar_body(
    const int32_t* __restrict__ q, int qmax, const int32_t* __restrict__ qlen,
    const int32_t* __restrict__ t, int tmax, const int32_t* __restrict__ tlen,
    const int32_t* __restrict__ w, int64_t B,
    const int32_t* __restrict__ mat, const int32_t* __restrict__ pens,
    int32_t* __restrict__ score, int8_t* __restrict__ steps,
    unsigned char* scratch, int64_t slot_bytes) {
  const GroupIdx<G> gi = group_idx<G>();
  const int tg = gi.tg;
  const int ncol = strip_cols<G, C>(qmax);
  unsigned char* slot = scratch + gi.group * slot_bytes;
  uint8_t* z = reinterpret_cast<uint8_t*>(slot);
  auto row = make_row<G, C>(slot + ((int64_t)tmax * qmax + 15) / 16 * 16,
                            tg, ncol);
  const Pens p = load_pens(pens);
  for (int64_t lane = gi.group; lane < B; lane += gi.groups) {
    const int s = global_task<G>(row, q + lane * qmax, qmax, t + lane * tmax,
                                 tmax, qlen[lane], tlen[lane], w[lane], mat,
                                 p, tg, z, steps + lane, B);
    if (tg == 0) score[lane] = s;
  }
}

// A group's slot: the z plane, then the memory row.
template <int G, int C>
inline int64_t global_slot_bytes(int qmax, int tmax) {
  return ((int64_t)tmax * qmax + 15) / 16 * 16 + mem_row_bytes<G, C>(qmax);
}

}  // namespace sw
