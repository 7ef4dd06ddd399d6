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
// coding back to front (0=M 1=D 2=I 3=done); err (1,) int32 is set to 1
// if a lane's band is wider than the window sized from `band`.
//
// The group follows the band.  Row i's band is the columns [beg, end),
// beg = max(i - w, 0), end = min(i + w + 1, qlen), w = max(w, |tlen -
// qlen|): at most `band` = min(2w + 1, qlen) columns, and the host passes
// the widest band of the round.  The group holds a window of Wn >= band
// columns that starts at beg: thread k owns the window offsets [kC, (k+1)C)
// (in registers, RegRow; above 256 columns in the group's slot of global
// scratch, MemRow).  So the band is always the window's first end - beg
// offsets, and when beg moves one column right (every row past the w-th)
// the window moves with it: E and the query codes move down one offset
// (E across a strip edge by one __shfl_down_sync; the column that comes in
// at the top was never in the band, so its E is NEG), while H(i-1, j-1),
// the diagonal of column j, is then the H that the same offset held.  The
// task's base codes are staged in its slot first, so a row reads its
// target base and a strip its incoming query code from there.  The row
// state is ksw's eh_h / eh_e: offset o holds eh_h[j+1] and eh_e[j] of
// column j = beg + o; eh_h[0] (the left edge) is one value a group.  A
// row i:
// - pass 1: E and the query codes moved if beg moved; M = eh_h[j] +
//   mat[t_i][q_j] (the 5x5 matrix copied into the group's slot), kept in
//   the row; the strip's maximum of A = M + e_ins*j over the band;
// - F(j) = max_{j'<j} A(j') - oe_ins - e_ins*(j-1) with NEG below the
//   band, F(0) = NEG: an exclusive prefix maximum across the group (NEG
//   for thread 0), run on along the strip;
// - pass 2: the z code (H direction in bits 0-1, 0x04 "E goes on", 0x20
//   "F goes on" (0x08 in a nibble), E and F opening from M), H, and E in
//   the band; eh_h[0] = the left edge -(o_del + e_del*(i+1)) while beg ==
//   0.
// ksw's eh_h[beg] = NEG (beg > 0) and eh_e[end] = NEG are not written: the
// band only moves right, so eh_h[beg] is never read again, eh_e[end] still
// holds the NEG it came in with, and the H of a column outside the band is
// never a later row's diagonal (it is left as pass 2 makes it).  All of it
// is plain int32 arithmetic around NEG = -(1 << 28), as in the plain
// version.
//
// The z codes are kept band-compressed: row i's window (0 outside the
// band) in the group's plane, as nibbles two rows a byte (tmax*Wn/2 bytes a
// task) where the strip is in registers, as bytes for the memory row.  The
// plane is in the block's shared memory when a block's slots fit there, in
// the group's slot of global scratch when they do not (wide retry bands,
// long targets): the same body, the address chosen per launch.  Thread 0
// walks the traceback from the plane (a cell outside the band reads 0, as
// the plain version's zero-filled volume gives): which = (z >> (which <<
// 1)) & 3, each op into the slot's staging bytes, then the D/I tail after
// either edge; the group then writes the task's steps, thread k the rows
// k, k+G, ... (a block's tasks are consecutive lanes, so their bytes of a
// row fall in one segment).

#pragma once

#include "local_sw.cuh"

namespace sw {

constexpr int kNeg = -(1 << 28);        // pipeline/cigar.NEG_INF

// The window of Wn columns of a launch with groups of G threads and strips
// of C columns (C == 0: the memory row, ceil(band / G) columns a thread).
template <int G, int C>
__host__ __device__ inline int global_window(int band) {
  return G * (C > 0 ? C : ((band > 1 ? band : 1) + G - 1) / G);
}

// A group's slot: the matrix (128 B; used where the slot is in shared
// memory), the staging of the steps (qmax + tmax bytes), the task's base
// codes (tmax target codes, then qmax + Wn query codes, 4 past qlen), the
// z plane (Wn bytes a row, or a pair of rows where kNibbles), then the
// memory row (C == 0), each part a
// multiple of 16 bytes.
struct GlobalSlot {
  int64_t ops, codes, plane, row, bytes;
};

template <int G, int C>
__host__ __device__ inline GlobalSlot global_slot(int qmax, int tmax,
                                                  int band) {
  const int wn = global_window<G, C>(band);
  GlobalSlot s;
  s.ops = 128;
  s.codes = s.ops + ((int64_t)qmax + tmax + 15) / 16 * 16;
  s.plane = s.codes + ((int64_t)tmax + qmax + wn + 15) / 16 * 16;
  const int64_t rows = C > 0 ? (tmax + 1) / 2 : tmax;  // kNibbles<C>
  s.row = s.plane + (rows * wn + 15) / 16 * 16;
  s.bytes = s.row + (C > 0 ? 0 : ((int64_t)wn * 9 + 15) / 16 * 16);
  return s;
}

// How a row's z codes are kept: a byte a cell (the memory row), or a
// nibble a cell, two rows a byte (a strip in registers): an even row's
// nibbles wait in a register for the odd row, whose pass writes the
// pairs.  A nibble holds the H direction in bits 0-1, "E goes on" in bit
// 2 and "F goes on" in bit 3; the walk puts bit 3 back at 0x20.
enum ZKeep { kZByte, kZEven, kZOdd };

// The fill of one task by the group of G threads that this thread is
// number tg of: tc and qc are the task's target and query codes in its
// slot (qc 4 past qn), qn and tn the lengths clamped to the windows, w the
// task's band half width (already max(w, |tlen - qlen|)), `first` =
// min(w, qlen).  The z codes of row i's window (0 outside the band) go to
// plane[i * wn, (i+1) * wn) as bytes (the memory row), or as the low
// (even i) and high (odd i) nibbles of plane[(i/2) * wn, (i/2+1) * wn).
template <int G, class Row>
struct GlobalFill {
  Row& row;
  const uint8_t *qc, *tc;
  int qn, tn, w;
  const int32_t* smat;
  const Pens& p;
  int tg;
  uint8_t* plane;
  int wn;
  int hleft = 0;  // eh_h[0]
  int beg = 0;
  int t_next = 0;
  uint32_t zp = 0;  // the even row's nibbles, cell c at bits 4c

  template <ZKeep kKeep>
  __device__ __forceinline__ void step(int i) {
    const unsigned gmask = group_mask<G>();
    const int ncol = Row::kC > 0 ? Row::kC : row.ncol();
    const int j0 = tg * ncol;
    const int oe_del = p.o_del + p.e_del, oe_ins = p.o_ins + p.e_ins;
    // this row's target base; the next row's loaded now, off its chain
    const int32_t* srow = smat + 5 * t_next;
    t_next = tc[imin(i + 1, tn - 1)];
    const int nbeg = imax(i - w, 0);
    const bool mv = nbeg != beg;  // the window moves one column right
    beg = nbeg;
    const int nb = imin(i + w + 1, qn) - beg;  // the band: offsets < nb
    // the neighbours' values before anything moves: the H below the
    // strip (the diagonal of its first column when the window stays),
    // the E above it (its last column's when it moves); the query code
    // that comes into the strip's last column then
    int hprev = __shfl_up_sync(gmask, row.h(ncol - 1), 1, G);
    int enext = __shfl_down_sync(gmask, row.e(0), 1, G);
    const int qnext = qc[beg + j0 + ncol - 1];
    if (tg == 0) hprev = hleft;
    if (tg == G - 1) enext = kNeg;
    // pass 1: move E and the codes, M replaces eh_h[j+1]
    int smax = kNeg;
#pragma unroll
    for (int c = 0; c < ncol; ++c) {
      const int hv = row.h(c);
      const int ev = mv ? (c + 1 < ncol ? row.e(c + 1) : enext) : row.e(c);
      const int qv = mv ? (c + 1 < ncol ? row.q(c + 1) : qnext) : row.q(c);
      const int m = (mv ? hv : hprev) + srow[qv];
      hprev = hv;
      row.set_e(c, ev);
      row.set_q(c, qv);
      row.set_h(c, m);
      if (j0 + c < nb) smax = imax(smax, m + p.e_ins * (beg + j0 + c));
    }
    int s = exclusive_max<G>(smax, tg, gmask, kNeg);
    // pass 2
    constexpr int kF = kKeep == kZByte ? 0x20 : 0x08;
    uint8_t* zrow = plane + (kKeep == kZByte ? i : i >> 1) * wn + j0;
#pragma unroll
    for (int c = 0; c < ncol; ++c) {
      const int j = beg + j0 + c;
      const bool inb = j0 + c < nb;
      const int m = row.h(c), e = row.e(c);
      const int f = j == 0 ? kNeg : s - oe_ins - p.e_ins * (j - 1);
      if (inb) s = imax(s, m + p.e_ins * j);
      int d = m < e ? 1 : 0;
      const int hme = imax(m, e);
      if (f > hme) d = 2;
      if (e - p.e_del > m - oe_del) d |= 0x04;
      if (f - p.e_ins > m - oe_ins) d |= kF;
      d = inb ? d : 0;
      // (every cell of the window written, no store under a predicate:
      // one cost the fill a third of its time on the card)
      if constexpr (kKeep == kZByte) {
        zrow[c] = (uint8_t)d;
      } else if constexpr (kKeep == kZEven) {
        zp = c == 0 ? (uint32_t)d : zp | ((uint32_t)d << (4 * c));
      } else {
        zrow[c] = (uint8_t)(((zp >> (4 * c)) & 15u) | ((uint32_t)d << 4));
      }
      row.set_h(c, imax(hme, f));
      if (inb) row.set_e(c, imax(e - p.e_del, m - oe_del));
    }
    if (beg == 0) hleft = -(p.o_del + p.e_del * (i + 1));
  }

  // the last row's nibbles when it is even (tn odd)
  __device__ __forceinline__ void flush(int i) {
    uint8_t* zrow = plane + (i >> 1) * wn + tg * Row::kC;
#pragma unroll
    for (int c = 0; c < Row::kC; ++c)
      zrow[c] = (uint8_t)((zp >> (4 * c)) & 15u);
  }
};

// Whether a launch keeps its z codes as nibbles (a strip in registers).
template <int C>
constexpr bool kNibbles = C > 0;

// Runs the fill (GlobalFill) of one task; returns the score, eh_h[qlen]
// (uniform across the group).
template <int G, class Row>
__device__ __forceinline__ int global_fill(
    Row& row, const uint8_t* qc, int qn, const uint8_t* tc, int tn, int w,
    int first, const int32_t* smat, const Pens& p, int tg, uint8_t* plane,
    int wn) {
  const unsigned gmask = group_mask<G>();
  const int ncol = Row::kC > 0 ? Row::kC : row.ncol();
  const int j0 = tg * ncol;
  // the first row: eh_h[j] = -(o_ins + e_ins*j) for 1 <= j <= min(w,
  // qlen), NEG past it; eh_h[0] = 0; eh_e = NEG
#pragma unroll
  for (int c = 0; c < ncol; ++c) {
    const int j = j0 + c;
    row.set_q(c, qc[j]);
    row.set_h(c, j + 1 <= first ? -(p.o_ins + p.e_ins * (j + 1)) : kNeg);
    row.set_e(c, kNeg);
  }
  GlobalFill<G, Row> f{row, qc, tc, qn, tn, w, smat, p, tg, plane, wn};
  f.t_next = tn > 0 ? tc[0] : 0;
  if constexpr (kNibbles<Row::kC>) {
    static_assert(Row::kC <= 8, "a strip's nibbles fill one register");
    int i = 0;
    for (; i + 1 < tn; i += 2) {
      f.template step<kZEven>(i);
      f.template step<kZOdd>(i + 1);
    }
    if (i < tn) {
      f.template step<kZEven>(i);
      f.flush(i);
    }
  } else {
    for (int i = 0; i < tn; ++i) f.template step<kZByte>(i);
  }
  // the score from the thread that owns column qlen - 1
  if (qn <= 0) return f.hleft;
  const int o = qn - 1 - f.beg;
  int mine = 0;
#pragma unroll
  for (int c = 0; c < ncol; ++c)
    if (j0 + c == o) mine = row.h(c);
  return __shfl_sync(gmask, mine, o / ncol, G);
}

// The traceback walk of one task from its plane (GlobalFill's layout:
// nibbles two rows a byte when kNib, else bytes; Wn bytes a plane row):
// the ops of the steps while both i and k are in the matrix go to ops[0,
// n); returns n, and *tail the op of the steps after it (1 = D while i >=
// 0, 2 = I while k >= 0) and *n_tail their number.  A cell outside the
// band reads 0.  Along the chain of dependent steps only the load, the op
// and the move of the offset o = k - beg and of the plane row: the band's
// bounds of each row are worked out beside it.
template <bool kNib>
__device__ __forceinline__ int global_walk(const uint8_t* plane, int wn,
                                           int tn, int qn, int w,
                                           uint8_t* ops, int* tail,
                                           int* n_tail) {
  int i = tn - 1, k = qn - 1, which = 0, n = 0;
  const uint8_t* zrow = plane + (kNib ? i >> 1 : i) * wn;
  int o = k - imax(i - w, 0);
  while (i >= 0 && k >= 0) {
    const int beg = imax(i - w, 0);
    const bool in = (unsigned)o < (unsigned)imin(imin(i + w + 1, qn) - beg,
                                                 wn);
    int zv = zrow[imin(imax(o, 0), wn - 1)];
    if constexpr (kNib) {
      zv = (zv >> ((i & 1) << 2)) & 15;
      zv += (zv & 8) * 3;  // "F goes on" back at 0x20
    }
    zv &= in ? 0xff : 0;
    which = (zv >> (which << 1)) & 3;
    ops[n++] = (uint8_t)which;
    const int di = which != 2, dk = which != 1;
    // the plane row moves down at every step of i (a row pair: from an
    // even i)
    zrow -= di && (!kNib || (i & 1) == 0) ? wn : 0;
    i -= di;
    k -= dk;
    // beg moves down with i while i - 1 >= w
    o += (di && i >= w ? 1 : 0) - dk;
  }
  *tail = i >= 0 ? 1 : 2;
  *n_tail = i >= 0 ? i + 1 : (k >= 0 ? k + 1 : 0);
  return n;
}

// The kernel body for this thread: every task lane = group, group +
// groups, ... of the launch.  A group's slot (global_slot) is in the
// block's dynamic shared memory `smem` (the block's groups' slots side by
// side) when kShared, else in `scratch` (the grid's groups' slots).
template <int G, int C, bool kShared>
__device__ __forceinline__ void global_cigar_body(
    const int32_t* __restrict__ q, int qmax, const int32_t* __restrict__ qlen,
    const int32_t* __restrict__ t, int tmax, const int32_t* __restrict__ tlen,
    const int32_t* __restrict__ w, int64_t B, int band,
    const int32_t* __restrict__ mat, const int32_t* __restrict__ pens,
    int32_t* __restrict__ score, int8_t* __restrict__ steps,
    int32_t* __restrict__ err, unsigned char* scratch, unsigned char* smem) {
  const unsigned gmask = group_mask<G>();
  const int tg = threadIdx.x & (G - 1);
  const int per_block = blockDim.x / G;
  const int64_t group = (int64_t)blockIdx.x * per_block + threadIdx.x / G;
  const int64_t groups = (int64_t)gridDim.x * per_block;
  const GlobalSlot ls = global_slot<G, C>(qmax, tmax, band);
  unsigned char* slot = kShared ? smem + (threadIdx.x / G) * ls.bytes
                                : scratch + group * ls.bytes;
  const int wn = global_window<G, C>(band);
  uint8_t* ops = slot + ls.ops;
  uint8_t* tc = slot + ls.codes;
  uint8_t* qc = tc + tmax;
  uint8_t* plane = slot + ls.plane;
  auto row = make_row<G, C>(slot + ls.row, tg, wn / G);
  // the matrix: a copy in the slot's shared memory, or (slots in global
  // scratch) read where it is
  const int32_t* smat = mat;
  if constexpr (kShared) {
    int32_t* copy = reinterpret_cast<int32_t*>(slot);
    for (int k = tg; k < 25; k += G) copy[k] = mat[k];
    __syncwarp(gmask);
    smat = copy;
  }
  const Pens p = load_pens(pens);
  const int smax = qmax + tmax;
  for (int64_t lane = group; lane < B; lane += groups) {
    const int ql = qlen[lane], tl = tlen[lane];
    int wl = w[lane];
    {
      const int d = tl - ql;
      wl = imax(wl, d < 0 ? -d : d);
    }
    const int qn = imin(imax(ql, 0), qmax), tn = imin(imax(tl, 0), tmax);
    // a lane whose band min(2w' + 1, qlen) the window cannot hold (a band
    // from the host narrower than the lane's): its result would be wrong,
    // so the error word tells the host, which raises
    if (tg == 0 && qn > wn && 2 * (int64_t)wl + 1 > wn) *err = 1;
    // the task's codes into its slot, 4 past the query
    for (int k = tg; k < tn; k += G)
      tc[k] = (uint8_t)code04(t[lane * tmax + k]);
    for (int k = tg; k < qmax + wn; k += G)
      qc[k] = (uint8_t)(k < qn ? code04(q[lane * qmax + k]) : 4);
    __syncwarp(gmask);
    const int s = global_fill<G>(row, qc, qn, tc, tn, wl, imin(wl, ql), smat,
                                 p, tg, plane, wn);
    __syncwarp(gmask);  // the z codes of every thread, for thread 0
    int n = 0, tail = 0, n_tail = 0;
    if (tg == 0) {
      n = global_walk<kNibbles<C>>(plane, wn, tn, qn, wl, ops, &tail,
                                   &n_tail);
      score[lane] = s;
    }
    __syncwarp(gmask);  // the staged ops, for every thread
    n = __shfl_sync(gmask, n, 0, G);
    tail = __shfl_sync(gmask, tail, 0, G);
    n_tail = __shfl_sync(gmask, n_tail, 0, G);
    int8_t* out = steps + lane;
    for (int st = tg; st < smax; st += G)
      out[st * B] =
          (int8_t)(st < n ? ops[st] : (st < n + n_tail ? tail : 3));
    __syncwarp(gmask);  // the plane and the staging are free again
  }
}

// The launch table: the group width G and strip length C of the window
// (Wn = G*C >= the round's widest band) for each band: whole warps, so
// that each task's rows go across 32 threads (a round is one wave of a
// few hundred to a few thousand tasks: narrower groups, several tasks a
// warp, were slower on every `mem` round that would take them).  Above
// 256 columns: the memory row of a whole warp (C == 0).
#define BWT_GLOBAL_TABLE(ROW)                                              \
  ROW(32, 32, 1) ROW(64, 32, 2) ROW(96, 32, 3) ROW(128, 32, 4)             \
  ROW(160, 32, 5) ROW(192, 32, 6) ROW(256, 32, 8)

// Calls fn.template run<G, C>() with the row of the launch table for a
// round whose widest band is `band` columns.
template <class Fn>
inline auto dispatch_global(int band, Fn&& fn)
    -> decltype(fn.template run<32, 0>()) {
#define BWT_GROW(BAND, G, C)                            \
  static_assert((G) * (C) >= (BAND), "a row's window"); \
  if (band <= BAND) return fn.template run<G, C>();
  BWT_GLOBAL_TABLE(BWT_GROW)
#undef BWT_GROW
  return fn.template run<32, 0>();
}

// The launch of a round: block and grid size, and where the slots are.
struct GlobalLaunch {
  bool shared;        // the slots in the blocks' shared memory
  unsigned blocks, threads;
  int64_t smem;       // dynamic shared memory a block
  int64_t scratch;    // bytes of global scratch (0 when shared)
};

// The launch for B tasks with groups of G threads and strips of C: the
// slots in shared memory when a block of 128, 64 or 32 threads (the
// largest that fits) has room for its groups' slots within smem_cap bytes
// (the card's opt-in limit a block); else 128-thread blocks with the slots
// in global scratch (sw::launch_grid).  The memory row is always global.
template <int G, int C>
inline GlobalLaunch global_launch(int qmax, int tmax, int band, int64_t B,
                                  int64_t smem_cap) {
  const int64_t slot = global_slot<G, C>(qmax, tmax, band).bytes;
  GlobalLaunch l{};
  for (int threads = kThreads; C > 0 && threads >= 32 && threads >= G;
       threads >>= 1) {
    const int64_t per_block = threads / G;
    if (slot * per_block > smem_cap) continue;
    int64_t n = (B + per_block - 1) / per_block;
    l.shared = true;
    l.threads = (unsigned)threads;
    l.blocks = (unsigned)(n < 1 ? 1 : (n > kMaxBlocks ? kMaxBlocks : n));
    l.smem = slot * per_block;
    return l;
  }
  l.threads = kThreads;
  launch_grid<G>(B, slot, &l.blocks, &l.scratch);
  return l;
}

}  // namespace sw
