// Runs the port's CUDA kernel bodies (extend_t_body, extend_fused_body of
// bwamem_tpu_torch/csrc/band_pass.cuh) on the CPU, compiled by g++ against
// the stand-in cuda_runtime.h beside this file:
//
//   g++ -O1 -std=c++17 -shared -fPIC -I tests/_simt -I bwamem_tpu_torch/csrc
//       -o libsimt.so tests/_simt/simt_emulate.cpp
//
// One alignment at a time, the G threads of its group run as ucontext
// fibers in a ring.  A collective writes the caller's value into one of
// two buffers (they alternate, so a fiber that runs ahead to the next
// collective cannot overwrite values that a parked fiber has yet to read)
// and switches to the next fiber; when a fiber is switched back to, the
// whole group has written.  The pass keeps a group's control flow uniform,
// which is what makes this ring a faithful schedule; a fiber that returns
// hands over to the next through uc_link.  Results must equal the plain
// PyTorch version's on every row: tests/test_torch_simt.py.

#include <ucontext.h>

#include <cstdlib>
#include <cstring>
#include <vector>

#include "band_pass.cuh"

SimtIdx threadIdx, blockIdx;

namespace simt {

constexpr int kMaxG = 32;
constexpr size_t kStack = 1 << 18;

struct Group {
  int G = 0, cur = 0;
  unsigned base = 0;  // threadIdx.x of the group's thread 0
  int buf[2][kMaxG];
  int calls[kMaxG];
  ucontext_t ctx[kMaxG], main_ctx;
  std::vector<char> stacks;
  void (*body)(void*) = nullptr;
  void* arg = nullptr;
};

static Group g;

int group_width() { return g.G; }
int thread_in_group() { return g.cur; }

static void become(int k) {
  g.cur = k;
  threadIdx.x = g.base + (unsigned)k;
}

const int* collective(int v) {
  const int me = g.cur, par = g.calls[me]++ & 1;
  g.buf[par][me] = v;
  const int next = (me + 1) % g.G;
  become(next);
  swapcontext(&g.ctx[me], &g.ctx[next]);
  become(me);
  return g.buf[par];
}

static void entry(int k) {
  become(k);
  g.body(g.arg);
}

// Run body(arg) once in each of the G threads of a group whose thread 0
// has threadIdx.x == base.
static void run_group(int G, unsigned base, void (*body)(void*), void* arg) {
  g.G = G;
  g.base = base;
  g.body = body;
  g.arg = arg;
  if (g.stacks.size() < kStack * kMaxG) g.stacks.resize(kStack * kMaxG);
  std::memset(g.calls, 0, sizeof(g.calls));
  for (int k = 0; k < G; ++k) {
    getcontext(&g.ctx[k]);
    g.ctx[k].uc_stack.ss_sp = g.stacks.data() + kStack * k;
    g.ctx[k].uc_stack.ss_size = kStack;
    g.ctx[k].uc_link = k + 1 < G ? &g.ctx[k + 1] : &g.main_ctx;
    makecontext(&g.ctx[k], (void (*)())entry, 1, k);
  }
  swapcontext(&g.main_ctx, &g.ctx[0]);
}

}  // namespace simt

namespace {

// Every alignment of a launch, group by group, with the block's shared
// memory and the indices a real launch would give each thread.
template <int G, int C, class Body>
int run_launch(int64_t B, int qmax, Body body) {
  unsigned blocks;
  int ncol;
  size_t smem_bytes;
  launch_shape<G, C>(B, qmax, &blocks, &ncol, &smem_bytes);
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
    return run_launch<G, C>(B, qmax, [s](int ncol, unsigned char* smem) {
      extend_t_body<G, C>(s.q, s.qmax, s.t, s.tmax, s.scal, s.B, s.p, s.out,
                          ncol, smem);
    });
  }
};

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
    return run_launch<G, C>(
        B, QL > QR ? QL : QR, [s](int ncol, unsigned char* smem) {
          extend_fused_body<G, C>(s.ql, s.QL, s.tl, s.TL, s.qr, s.QR, s.tr,
                                  s.TR, s.scal, s.B, s.p, s.out, ncol, smem);
        });
  }
};

}  // namespace

extern "C" {

// The launchers of extend_t.cu and extend_fused.cu without a stream: the
// same arguments over host memory, the same shape dispatch.
int emu_extend_t(const void* q, int qmax, const void* t, int tmax,
                 const void* scal, long long B, int a, int b, int o_del,
                 int e_del, int o_ins, int e_ins, int zdrop, void* out) {
  if (B <= 0) return 0;
  const EmuT l{static_cast<const int8_t*>(q), qmax,
               static_cast<const int8_t*>(t), tmax,
               static_cast<const int32_t*>(scal), (int64_t)B,
               Prm{a, b, o_del, e_del, o_ins, e_ins, zdrop},
               static_cast<int*>(out)};
  return dispatch_shape(qmax, l);
}

int emu_extend_fused(const void* ql, int QL, const void* tl, int TL,
                     const void* qr, int QR, const void* tr, int TR,
                     const void* scal, long long B, int a, int b, int o_del,
                     int e_del, int o_ins, int e_ins, int zdrop, void* out) {
  if (B <= 0) return 0;
  const EmuFused l{static_cast<const int8_t*>(ql),
                   static_cast<const int8_t*>(tl),
                   static_cast<const int8_t*>(qr),
                   static_cast<const int8_t*>(tr),
                   QL, TL, QR, TR,
                   static_cast<const int32_t*>(scal), (int64_t)B,
                   Prm{a, b, o_del, e_del, o_ins, e_ins, zdrop},
                   static_cast<int*>(out)};
  return dispatch_shape(QL > QR ? QL : QR, l);
}

}  // extern "C"
