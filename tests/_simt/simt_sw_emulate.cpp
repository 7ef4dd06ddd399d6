// Runs the mate-rescue and CIGAR kernel bodies (local_align6_body of
// bwamem_tpu_torch/csrc/local_sw.cuh, global_cigar_body of global_sw.cuh)
// on the CPU, compiled by g++ against the stand-in cuda_runtime.h beside
// this file:
//
//   g++ -O1 -std=c++17 -shared -fPIC -I tests/_simt -I bwamem_tpu_torch/csrc
//       -o libsimt_sw.so tests/_simt/simt_sw_emulate.cpp
//
// The launch is the one local_sw.cu and global_sw.cu make: the same shape
// tables (sw::dispatch_sw; for the CIGAR kernel sw::dispatch_global from
// the round's band), the same grid, block and scratch (sw::launch_grid,
// sw::global_launch, given the card's shared-memory limit a block as an
// argument), and every group of every block runs the body with the indices
// a real launch gives its threads, the threads of a group as fibers
// (simt_fibers.h).  The scratch and the blocks' shared memory start as
// garbage, so a read of a slot before its write shows.
// Results must equal the plain PyTorch versions' on every lane:
// tests/test_torch_simt_sw.py.

#include "global_sw.cuh"
#include "simt_fibers.h"

namespace {

// Every group of a grid of `blocks` blocks of `threads` runs body().
template <int G, class Body>
void run_grid(unsigned blocks, Body body, unsigned threads = sw::kThreads) {
  gridDim.x = blocks;
  blockDim.x = threads;
  for (unsigned blk = 0; blk < blocks; ++blk) {
    blockIdx.x = blk;
    for (int grp = 0; grp < (int)threads / G; ++grp)
      simt::run_group(
          G, (unsigned)(grp * G),
          [](void* a) { (*static_cast<Body*>(a))(); }, &body);
  }
}

std::vector<unsigned char> garbage(int64_t bytes) {
  std::vector<unsigned char> v((size_t)bytes + 16);
  for (size_t k = 0; k < v.size(); ++k) v[k] = (unsigned char)(0xA5 ^ k);
  return v;
}

struct EmuLocal {
  const int32_t *q, *qlen, *t, *tlen, *mat, *pens;
  int qmax, tmax;
  int64_t B;
  int32_t* out;
  template <int G, int C>
  int run() const {
    const int64_t slot = sw::local_slot_bytes<G, C>(qmax, tmax);
    unsigned blocks;
    int64_t bytes;
    sw::launch_grid<G>(B, slot, &blocks, &bytes);
    std::vector<unsigned char> scratch = garbage(bytes);
    const EmuLocal& s = *this;
    unsigned char* sp = scratch.data();
    run_grid<G>(blocks, [&s, sp, slot]() {
      sw::local_align6_body<G, C>(s.q, s.qmax, s.qlen, s.t, s.tmax, s.tlen,
                                  s.B, s.mat, s.pens, s.out, sp, slot);
    });
    return 0;
  }
};

// G, C, slots in shared memory, blocks, threads of the last CIGAR launch
int last_global[5];

struct EmuGlobal {
  const int32_t *q, *qlen, *t, *tlen, *w, *mat, *pens;
  int qmax, tmax, band;
  int64_t B, smem_cap;
  int32_t* score;
  int8_t* steps;
  int32_t* err;
  template <int G, int C>
  int run() const {
    const sw::GlobalLaunch l =
        sw::global_launch<G, C>(qmax, tmax, band, B, smem_cap);
    const int shape[5] = {G, C, l.shared, (int)l.blocks, (int)l.threads};
    std::copy(shape, shape + 5, last_global);
    std::vector<unsigned char> scratch = garbage(l.scratch);
    std::vector<unsigned char> smem = garbage(l.smem);
    const EmuGlobal& s = *this;
    unsigned char* sp = scratch.data();
    unsigned char* mp = smem.data();
    run_grid<G>(
        l.blocks,
        [&s, &l, sp, mp]() {
          if constexpr (C > 0) {
            if (l.shared) {
              sw::global_cigar_body<G, C, true>(
                  s.q, s.qmax, s.qlen, s.t, s.tmax, s.tlen, s.w, s.B, s.band,
                  s.mat, s.pens, s.score, s.steps, s.err, nullptr, mp);
              return;
            }
          }
          sw::global_cigar_body<G, C, false>(
              s.q, s.qmax, s.qlen, s.t, s.tmax, s.tlen, s.w, s.B, s.band,
              s.mat, s.pens, s.score, s.steps, s.err, sp, nullptr);
        },
        l.threads);
    return 0;
  }
};

struct Shape {
  int* g;
  int* c;
  int* blocks;
  int64_t B;
  template <int G, int C>
  int run() const {
    unsigned n;
    int64_t bytes;
    sw::launch_grid<G>(B, 0, &n, &bytes);
    *g = G;
    *c = C;
    *blocks = (int)n;
    return 0;
  }
};

}  // namespace

extern "C" {

// The launchers of local_sw.cu and global_sw.cu without a stream or
// device scratch: the same arguments over host memory.
int emu_local_align6(const void* q, int qmax, const void* qlen,
                     const void* t, int tmax, const void* tlen, long long B,
                     const void* mat, const void* pens, void* out) {
  if (B <= 0) return 0;
  const EmuLocal l{static_cast<const int32_t*>(q),
                   static_cast<const int32_t*>(qlen),
                   static_cast<const int32_t*>(t),
                   static_cast<const int32_t*>(tlen),
                   static_cast<const int32_t*>(mat),
                   static_cast<const int32_t*>(pens),
                   qmax, tmax, (int64_t)B, static_cast<int32_t*>(out)};
  return sw::dispatch_sw(qmax, l);
}

// bwt_global_cigar's launcher, the card's shared memory a block given as
// smem_cap (its band clamped to [1, qmax] as there); the shape of the
// launch goes to emu_global_last.
int emu_global_cigar(const void* q, int qmax, const void* qlen,
                     const void* t, int tmax, const void* tlen, const void* w,
                     long long B, int band, const void* mat, const void* pens,
                     void* score, void* steps, void* err,
                     long long smem_cap) {
  if (B <= 0) return 0;
  band = band > qmax ? (qmax > 1 ? qmax : 1) : (band < 1 ? 1 : band);
  const EmuGlobal l{static_cast<const int32_t*>(q),
                    static_cast<const int32_t*>(qlen),
                    static_cast<const int32_t*>(t),
                    static_cast<const int32_t*>(tlen),
                    static_cast<const int32_t*>(w),
                    static_cast<const int32_t*>(mat),
                    static_cast<const int32_t*>(pens),
                    qmax, tmax, band, (int64_t)B, (int64_t)smem_cap,
                    static_cast<int32_t*>(score),
                    static_cast<int8_t*>(steps), static_cast<int32_t*>(err)};
  return sw::dispatch_global(band, l);
}

// (G, C, slots in shared memory, blocks, threads) of the last
// emu_global_cigar launch.
void emu_global_last(int* out) {
  std::copy(last_global, last_global + 5, out);
}

// The group width, strip length (0: the memory row) and blocks of a launch
// over B tasks in a query window of qmax columns.
int emu_sw_shape(int qmax, long long B, int* g, int* c, int* blocks) {
  return sw::dispatch_sw(qmax, Shape{g, c, blocks, (int64_t)B});
}

}  // extern "C"
