// Runs the port's CUDA kernel bodies (extend_t_body, extend_fused_body of
// bwamem_tpu_torch/csrc/band_pass.cuh) on the CPU, compiled by g++ against
// the stand-in cuda_runtime.h beside this file:
//
//   g++ -O1 -std=c++17 -shared -fPIC -I tests/_simt -I bwamem_tpu_torch/csrc
//       -o libsimt.so tests/_simt/simt_emulate.cpp
//
// One alignment at a time, the G threads of its group run as fibers
// (simt_fibers.h).  Results must equal the plain PyTorch version's on
// every row: tests/test_torch_simt.py and tests/test_torch_simt16.py.

#include "band_pass.cuh"
#include "simt_fibers.h"

namespace {

// G * 1000 + C of the last launch the dispatch chose
int last_shape = 0;

// Every alignment of a launch, group by group, with the block's shared
// memory and the indices a real launch would give each thread.
template <int G, int C, class Cell, class Body>
int run_launch(int64_t B, int qmax, Body body) {
  last_shape = G * 1000 + C;
  unsigned blocks;
  int ncol;
  size_t smem_bytes;
  launch_shape<G, C, Cell>(B, qmax, &blocks, &ncol, &smem_bytes);
  std::vector<unsigned char> smem(smem_bytes + 16);
  struct Arg {
    Body* body;
    int ncol;
    unsigned char* smem;
  } arg{&body, ncol, smem.data()};
  const int per_block = kThreads / G;
  for (unsigned blk = 0; blk < blocks; ++blk) {
    blockIdx.x = blk;
    for (int grp = 0; grp < per_block; ++grp)
      simt::run_group(
          G, (unsigned)(grp * G),
          [](void* a) {
            Arg* x = static_cast<Arg*>(a);
            (*x->body)(x->ncol, x->smem);
          },
          &arg);
  }
  return 0;
}

template <class Cell>
struct EmuT {
  const int8_t* q;
  int qmax;
  const int8_t* t;
  int tmax;
  const int32_t* scal;
  int64_t B;
  Prm p;
  int* out;
  template <int G, int C>
  int run() const {
    const EmuT& s = *this;
    return run_launch<G, C, Cell>(
        B, qmax, [s](int ncol, unsigned char* smem) {
          extend_t_body<G, C, Cell>(s.q, s.qmax, s.t, s.tmax, s.scal, s.B,
                                     s.p, s.out, ncol, smem);
        });
  }
};

template <class Cell>
struct EmuFused {
  const int8_t *ql, *tl, *qr, *tr;
  int QL, TL, QR, TR;
  const int32_t* scal;
  int64_t B;
  Prm p;
  int* out;
  template <int G, int C>
  int run() const {
    const EmuFused& s = *this;
    return run_launch<G, C, Cell>(
        B, QL > QR ? QL : QR, [s](int ncol, unsigned char* smem) {
          extend_fused_body<G, C, Cell>(s.ql, s.QL, s.tl, s.TL, s.qr, s.QR,
                                         s.tr, s.TR, s.scal, s.B, s.p, s.out,
                                         ncol, smem);
        });
  }
};

template <class Cell>
int emu_t(const void* q, int qmax, const void* t, int tmax, const void* scal,
          long long B, const Prm& p, void* out) {
  if (B <= 0) return 0;
  const EmuT<Cell> l{static_cast<const int8_t*>(q), qmax,
                     static_cast<const int8_t*>(t), tmax,
                     static_cast<const int32_t*>(scal), (int64_t)B, p,
                     static_cast<int*>(out)};
  return dispatch_cells<Cell>(qmax, l);
}

template <class Cell>
int emu_fused(const void* ql, int QL, const void* tl, int TL, const void* qr,
              int QR, const void* tr, int TR, const void* scal, long long B,
              const Prm& p, void* out) {
  if (B <= 0) return 0;
  const EmuFused<Cell> l{static_cast<const int8_t*>(ql),
                         static_cast<const int8_t*>(tl),
                         static_cast<const int8_t*>(qr),
                         static_cast<const int8_t*>(tr),
                         QL, TL, QR, TR,
                         static_cast<const int32_t*>(scal), (int64_t)B, p,
                         static_cast<int*>(out)};
  return dispatch_cells<Cell>(QL > QR ? QL : QR, l);
}

}  // namespace

extern "C" {

// G * 1000 + C (C = 0: the shared-memory row) of the last launch.
int emu_last_shape() { return last_shape; }

// The launchers of extend_t.cu and extend_fused.cu without a stream: the
// same arguments over host memory, the same shape dispatch, 32-bit cells
// and (_i16) packed 16-bit cells.
int emu_extend_t(const void* q, int qmax, const void* t, int tmax,
                 const void* scal, long long B, int a, int b, int o_del,
                 int e_del, int o_ins, int e_ins, int zdrop, void* out) {
  return emu_t<int32_t>(q, qmax, t, tmax, scal, B,
                        Prm{a, b, o_del, e_del, o_ins, e_ins, zdrop}, out);
}

int emu_extend_t_i16(const void* q, int qmax, const void* t, int tmax,
                     const void* scal, long long B, int a, int b, int o_del,
                     int e_del, int o_ins, int e_ins, int zdrop, void* out) {
  return emu_t<int16_t>(q, qmax, t, tmax, scal, B,
                        Prm{a, b, o_del, e_del, o_ins, e_ins, zdrop}, out);
}

int emu_extend_fused(const void* ql, int QL, const void* tl, int TL,
                     const void* qr, int QR, const void* tr, int TR,
                     const void* scal, long long B, int a, int b, int o_del,
                     int e_del, int o_ins, int e_ins, int zdrop, void* out) {
  return emu_fused<int32_t>(ql, QL, tl, TL, qr, QR, tr, TR, scal, B,
                            Prm{a, b, o_del, e_del, o_ins, e_ins, zdrop},
                            out);
}

int emu_extend_fused_i16(const void* ql, int QL, const void* tl, int TL,
                         const void* qr, int QR, const void* tr, int TR,
                         const void* scal, long long B, int a, int b,
                         int o_del, int e_del, int o_ins, int e_ins,
                         int zdrop, void* out) {
  return emu_fused<int16_t>(ql, QL, tl, TL, qr, QR, tr, TR, scal, B,
                            Prm{a, b, o_del, e_del, o_ins, e_ins, zdrop},
                            out);
}

}  // extern "C"
