// The one-thread-per-alignment pass that bwamem_tpu_torch/csrc/band_pass.cuh
// replaced, kept with its two kernels as the timing yardstick of
// chip_smoke.py.  Nothing in the package builds or loads these files.
//
// One banded ksw_extend2 pass per thread, shared by the port's extension
// kernels (extend_fused.cu, extend_t.cu).
//
// It is the row loop of the Pallas kernels' _band_pass in
// bwamem_tpu/ops/extend_pallas.py, written as the scalar recurrence of
// bwamem_tpu/ops/extend_ref.ksw_extend_core: the serial F recurrence,
// band clamp, zero-run trim, row_max == 0 break and Z-dropoff read
// directly from it.  The per-lane H/E row (eh_h, eh_e) lives in a global
// scratch of shape (qmax+2, B) int32 with the lane as the minor index, so
// a warp's 32 lanes touch neighbouring words at equal j.  What bounds it
// is scratch traffic and memory latency (two dependent loads and two
// stores per cell), not arithmetic.
//
// Each translation unit that includes this header gets its own copy of
// the device functions (no -rdc), so _build.py hashes headers with the
// sources.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

struct Prm {
  int a, b, o_del, e_del, o_ins, e_ins, zdrop;
};

struct PassOut {
  int best, max_j, max_i, max_ie, gscore, max_off;
};

// One banded extension pass of lane `lane` (ksw_extend_core).  q is the
// (qmax, B) query window, t the (tmax, B) target window, both int8 base
// codes (> 3 is N); eh_h/eh_e the (qmax+2, B) scratch.  `run` false, or
// qlen/tlen/h0 <= 0, leaves the lane untouched: best = h0, the rest of
// the fields at their initial values.
__device__ PassOut band_pass(const int8_t* __restrict__ q, int qmax,
                             const int8_t* __restrict__ t, int tmax,
                             int64_t B, int64_t lane, int qlen, int tlen,
                             int w, int h0, bool run, int* eh_h, int* eh_e,
                             const Prm& p) {
  PassOut r{h0, -1, -1, -1, -1, 0};
  if (!run || qlen <= 0 || tlen <= 0 || h0 <= 0) return r;
  if (qlen > qmax) qlen = qmax;  // memory safety; callers keep qlen <= qmax
  const int oe_del = p.o_del + p.e_del;
  const int oe_ins = p.o_ins + p.e_ins;
  int* H = eh_h + lane;  // H[j * B] = eh[j].h
  int* E = eh_e + lane;

  // first (virtual) row: h0, h0 - oe_ins, then decreasing by e_ins
  for (int j = 0; j <= qlen + 1; ++j) {
    H[j * B] = 0;
    E[j * B] = 0;
  }
  H[0] = h0;
  H[B] = h0 > oe_ins ? h0 - oe_ins : 0;
  for (int j = 2; j <= qlen && H[(j - 1) * B] > p.e_ins; ++j)
    H[j * B] = H[(j - 1) * B] - p.e_ins;

  int max_score = h0, max_i = -1, max_j = -1, max_ie = -1, gscore = -1;
  int max_off = 0;
  int beg = 0, end = qlen;
  for (int i = 0; i < tlen; ++i) {
    int f = 0, row_max = 0, mj = -1;
    const int ti = t[(int64_t)(i < tmax ? i : tmax - 1) * B + lane];
    const bool t_n = ti > 3;
    // band clamp
    if (beg < i - w) beg = i - w;
    if (end > i + w + 1) end = i + w + 1;
    if (end > qlen) end = qlen;
    int h1;
    if (beg == 0) {
      h1 = h0 - (p.o_del + p.e_del * (i + 1));
      if (h1 < 0) h1 = 0;
    } else {
      h1 = 0;
    }
    for (int j = beg; j < end; ++j) {
      // eh[j] holds {H(i-1, j-1), E(i, j)}; f = F(i, j); h1 = H(i, j-1)
      int M = H[j * B];
      int e = E[j * B];
      H[j * B] = h1;
      const int qj = q[(int64_t)j * B + lane];
      const int s = (t_n || qj > 3) ? -1 : (qj == ti ? p.a : -p.b);
      M = M ? M + s : 0;
      int h = M > e ? M : e;
      h = h > f ? h : f;
      h1 = h;
      if (h >= row_max) {  // ties pick the later j
        mj = j;
        row_max = h;
      }
      int tt = M - oe_del;
      tt = tt > 0 ? tt : 0;
      e -= p.e_del;
      e = e > tt ? e : tt;
      E[j * B] = e;
      tt = M - oe_ins;
      tt = tt > 0 ? tt : 0;
      f -= p.e_ins;
      f = f > tt ? f : tt;
    }
    if (end >= 0) {
      H[end * B] = h1;
      E[end * B] = 0;
    }
    if (end == qlen) {
      if (!(gscore > h1)) max_ie = i;
      if (h1 > gscore) gscore = h1;
    }
    if (row_max == 0) break;
    if (row_max > max_score) {
      max_score = row_max;
      max_i = i;
      max_j = mj;
      const int off = mj >= i ? mj - i : i - mj;
      if (off > max_off) max_off = off;
    } else if (p.zdrop > 0) {
      const int di = i - max_i, dj = mj - max_j;
      const int pen = di > dj ? (di - dj) * p.e_del : (dj - di) * p.e_ins;
      if (max_score - row_max - pen > p.zdrop) break;
    }
    // zero-run band trimming for the next row
    int j = beg;
    while (j < end && H[j * B] == 0 && E[j * B] == 0) ++j;
    beg = j;
    j = end;
    while (j >= beg && H[j * B] == 0 && E[j * B] == 0) --j;
    end = j + 2 < qlen ? j + 2 : qlen;
  }
  r.best = max_score;
  r.max_j = max_j;
  r.max_i = max_i;
  r.max_ie = max_ie;
  r.gscore = gscore;
  r.max_off = max_off;
  return r;
}

// The 8 output rows of one pass from row `row0` of `out` (rows, B):
// [score, qle, tle, gtle, gscore, max_off, aw, 0].
__device__ void emit(int* out, int64_t B, int64_t lane, int row0,
                     const PassOut& r, int aw) {
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

}  // namespace
