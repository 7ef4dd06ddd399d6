// The CIGAR global alignment for Hopper (sm_90a): the banded fill and the
// traceback of every task of a CIGAR round in one launch
// (bwt_global_cigar).
//
// Replaces the JAX package's one compiled program for a round,
// bwamem_tpu/ops/global_jax._global_batch (XLA, not Pallas: the fill and
// the traceback as two lax.scans under one jit), whose plain PyTorch
// version (ops/global_torch.global_batch) runs a Python loop of tens of
// thousands of launches a round.  The body is global_sw.cuh's: a group of
// threads a task over the strips of sw_rows.cuh, the z codes in the
// group's slot of scratch, one thread's traceback.  Score and steps equal
// the plain version's on every lane.
//
// Plain C interface (built with nvcc into the port's kernel library and
// loaded with ctypes, ops/_build.py): pointers and the stream arrive as
// void*; the launcher returns cudaGetLastError().

#include "global_sw.cuh"

namespace {

template <int G, int C>
__global__ void __launch_bounds__(sw::kThreads)
    global_cigar_kernel(const int32_t* __restrict__ q, int qmax,
                        const int32_t* __restrict__ qlen,
                        const int32_t* __restrict__ t, int tmax,
                        const int32_t* __restrict__ tlen,
                        const int32_t* __restrict__ w, int64_t B,
                        const int32_t* __restrict__ mat,
                        const int32_t* __restrict__ pens,
                        int32_t* __restrict__ score,
                        int8_t* __restrict__ steps, unsigned char* scratch,
                        int64_t slot_bytes) {
  sw::global_cigar_body<G, C>(q, qmax, qlen, t, tmax, tlen, w, B, mat, pens,
                              score, steps, scratch, slot_bytes);
}

struct Launch {
  const int32_t *q, *qlen, *t, *tlen, *w, *mat, *pens;
  int qmax, tmax;
  int64_t B;
  int32_t* score;
  int8_t* steps;
  unsigned char* scratch;
  cudaStream_t stream;

  template <int G, int C>
  int run() const {
    const int64_t slot = sw::global_slot_bytes<G, C>(qmax, tmax);
    unsigned blocks;
    int64_t bytes;
    sw::launch_grid<G>(B, slot, &blocks, &bytes);
    global_cigar_kernel<G, C><<<blocks, sw::kThreads, 0, stream>>>(
        q, qmax, qlen, t, tmax, tlen, w, B, mat, pens, score, steps, scratch,
        slot);
    return (int)cudaGetLastError();
  }
};

struct Scratch {
  int qmax, tmax;
  int64_t B;
  template <int G, int C>
  int64_t run() const {
    unsigned blocks;
    int64_t bytes;
    sw::launch_grid<G>(B, sw::global_slot_bytes<G, C>(qmax, tmax), &blocks,
                       &bytes);
    return bytes;
  }
};

}  // namespace

extern "C" {

// Bytes of device scratch that bwt_global_cigar needs for these shapes.
long long bwt_global_cigar_scratch(int qmax, int tmax, long long B) {
  return sw::dispatch_sw(qmax, Scratch{qmax, tmax, (int64_t)B});
}

// Fill and traceback of B tasks on `stream`: q (B, qmax), t (B, tmax),
// qlen, tlen, w (B,), mat (5, 5), pens (4,) int32; score (B,) int32, steps
// (qmax + tmax, B) int8; scratch of bwt_global_cigar_scratch bytes.
// Returns cudaGetLastError().
int bwt_global_cigar(const void* q, int qmax, const void* qlen,
                     const void* t, int tmax, const void* tlen, const void* w,
                     long long B, const void* mat, const void* pens,
                     void* score, void* steps, void* scratch, void* stream) {
  if (B <= 0) return 0;
  const Launch l{static_cast<const int32_t*>(q),
                 static_cast<const int32_t*>(qlen),
                 static_cast<const int32_t*>(t),
                 static_cast<const int32_t*>(tlen),
                 static_cast<const int32_t*>(w),
                 static_cast<const int32_t*>(mat),
                 static_cast<const int32_t*>(pens),
                 qmax, tmax, (int64_t)B, static_cast<int32_t*>(score),
                 static_cast<int8_t*>(steps),
                 static_cast<unsigned char*>(scratch),
                 static_cast<cudaStream_t>(stream)};
  return sw::dispatch_sw(qmax, l);
}

}  // extern "C"
