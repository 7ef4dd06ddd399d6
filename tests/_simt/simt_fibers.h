// The fibers that run the threads of one group of a CUDA kernel body on
// the CPU, for the stand-in cuda_runtime.h beside this file (which declares
// simt::collective, group_width and thread_in_group): included by the
// emulators simt_emulate.cpp, simt_sw_emulate.cpp and
// simt_seed_emulate.cpp, each built into a library of its own.
//
// One group at a time, its G threads run as ucontext fibers in a ring.  A
// collective writes the caller's value into one of two buffers (they
// alternate, so a fiber that runs ahead to the next collective cannot
// overwrite values that a parked fiber has yet to read) and switches to
// the next fiber; when a fiber is switched back to, the whole group has
// written.  The kernel bodies keep a group's control flow uniform, which
// is what makes this ring a faithful schedule; a fiber that returns hands
// over to the next through uc_link.

#pragma once

#include <ucontext.h>

#include <cstdlib>
#include <cstring>
#include <vector>

#include <cuda_runtime.h>

namespace simt {

constexpr int kMaxG = 32;
constexpr size_t kStack = 1 << 18;

struct Group {
  int G = 0, cur = 0;
  unsigned base = 0;  // threadIdx.x of the group's thread 0
  long long buf[2][kMaxG];
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

const long long* collective(long long v) {
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
