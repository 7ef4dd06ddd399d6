// The CIGAR global alignment for Hopper (sm_90a): the banded fill and the
// traceback of every task of a CIGAR round in one launch
// (bwt_global_cigar).
//
// Replaces the JAX package's one compiled program for a round,
// bwamem_tpu/ops/global_jax._global_batch (XLA, not Pallas: the fill and
// the traceback as two lax.scans under one jit), whose plain PyTorch
// version (ops/global_torch.global_batch) runs a Python loop of tens of
// thousands of launches a round.  The body is global_sw.cuh's: a warp a
// task over a window that follows the band, sized from the round's widest
// band (BWT_GLOBAL_TABLE), the z codes
// band-compressed in the group's slot of the block's shared memory (or of
// global scratch where the slots do not fit), one thread's traceback from
// there.  Score and steps equal the plain version's on every lane.
//
// Plain C interface (built with nvcc into the port's kernel library and
// loaded with ctypes, ops/_build.py): pointers and the stream arrive as
// void*; the launcher returns cudaGetLastError().

#include "global_sw.cuh"

namespace {

// (a minimum of one block an SM lets ptxas take the registers the strip
// needs: without it some instantiations spill)
template <int G, int C, bool kShared>
__global__ void __launch_bounds__(sw::kThreads, 1)
    global_cigar_kernel(const int32_t* __restrict__ q, int qmax,
                        const int32_t* __restrict__ qlen,
                        const int32_t* __restrict__ t, int tmax,
                        const int32_t* __restrict__ tlen,
                        const int32_t* __restrict__ w, int64_t B, int band,
                        const int32_t* __restrict__ mat,
                        const int32_t* __restrict__ pens,
                        int32_t* __restrict__ score,
                        int8_t* __restrict__ steps,
                        int32_t* __restrict__ err, unsigned char* scratch) {
  extern __shared__ uint4 smem[];
  sw::global_cigar_body<G, C, kShared>(
      q, qmax, qlen, t, tmax, tlen, w, B, band, mat, pens, score, steps,
      err, scratch, reinterpret_cast<unsigned char*>(smem));
}

// The card's limit of dynamic shared memory a block (opt-in).
int64_t smem_cap() {
  int dev = 0, v = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return v;
}

// The band the launch is sized for: at least one column, at most qmax.
int clamp_band(int band, int qmax) {
  return band > qmax ? (qmax > 1 ? qmax : 1) : (band < 1 ? 1 : band);
}

struct Launch {
  const int32_t *q, *qlen, *t, *tlen, *w, *mat, *pens;
  int qmax, tmax, band;
  int64_t B;
  int32_t* score;
  int8_t* steps;
  int32_t* err;
  unsigned char* scratch;
  cudaStream_t stream;

  template <int G, int C, bool kShared>
  int go(const sw::GlobalLaunch& l) const {
    auto kernel = global_cigar_kernel<G, C, kShared>;
    if (l.smem > 48 * 1024)  // above 48 KB only when asked for
      cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)l.smem);
    kernel<<<l.blocks, l.threads, (size_t)l.smem, stream>>>(
        q, qmax, qlen, t, tmax, tlen, w, B, band, mat, pens, score, steps,
        err, scratch);
    return (int)cudaGetLastError();
  }

  template <int G, int C>
  int run() const {
    const sw::GlobalLaunch l =
        sw::global_launch<G, C>(qmax, tmax, band, B, smem_cap());
    if constexpr (C > 0) {
      if (l.shared) return go<G, C, true>(l);
    }
    return go<G, C, false>(l);
  }
};

// The bytes of global scratch of the launch for these shapes and band.
struct Scratch {
  int qmax, tmax, band;
  int64_t B;
  template <int G, int C>
  int64_t run() const {
    return sw::global_launch<G, C>(qmax, tmax, band, B, smem_cap()).scratch;
  }
};

}  // namespace

extern "C" {

// Bytes of device scratch that bwt_global_cigar needs for these shapes and
// band (0 where the slots are in shared memory).
long long bwt_global_cigar_scratch(int qmax, int tmax, int band,
                                   long long B) {
  band = clamp_band(band, qmax);
  return sw::dispatch_global(band, Scratch{qmax, tmax, band, (int64_t)B});
}

// Fill and traceback of B tasks on `stream`: q (B, qmax), t (B, tmax),
// qlen, tlen, w (B,), mat (5, 5), pens (4,) int32; score (B,) int32, steps
// (qmax + tmax, B) int8; scratch of bwt_global_cigar_scratch bytes.  band
// >= every lane's min(2 max(w, |tlen - qlen|) + 1, qlen) (qmax always
// is); err (1,) int32, 0 before the launch, is set to 1 if a lane's band
// is wider than the launch's window (its result is then wrong).  Returns
// cudaGetLastError().
int bwt_global_cigar(const void* q, int qmax, const void* qlen,
                     const void* t, int tmax, const void* tlen, const void* w,
                     long long B, int band, const void* mat, const void* pens,
                     void* score, void* steps, void* err, void* scratch,
                     void* stream) {
  if (B <= 0) return 0;
  const Launch l{static_cast<const int32_t*>(q),
                 static_cast<const int32_t*>(qlen),
                 static_cast<const int32_t*>(t),
                 static_cast<const int32_t*>(tlen),
                 static_cast<const int32_t*>(w),
                 static_cast<const int32_t*>(mat),
                 static_cast<const int32_t*>(pens),
                 qmax, tmax, clamp_band(band, qmax), (int64_t)B,
                 static_cast<int32_t*>(score), static_cast<int8_t*>(steps),
                 static_cast<int32_t*>(err),
                 static_cast<unsigned char*>(scratch),
                 static_cast<cudaStream_t>(stream)};
  return sw::dispatch_global(l.band, l);
}

}  // extern "C"
