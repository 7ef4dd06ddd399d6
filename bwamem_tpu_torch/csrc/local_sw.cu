// The mate-rescue local alignment for Hopper (sm_90a): the whole ksw_align
// of a rescue wave in one launch (bwt_local_align6).
//
// Replaces the JAX package's one compiled program for a wave,
// bwamem_tpu/ops/local_jax._align6 (XLA, not Pallas: the forward fill
// _fill, the reversed-prefix second fill over _reverse_prefix, and KSW_XSUBO's
// second best, under one jit), whose plain PyTorch version
// (ops/local_torch.align6) runs a Python loop of tens of thousands of
// launches a wave.  The body is local_sw.cuh's: a group of threads a task,
// the strips of sw_rows.cuh, the launch table of sw_rows.cuh's dispatch_sw.
// Outputs equal the plain version's on every row of every lane.
//
// Plain C interface (built with nvcc into the port's kernel library and
// loaded with ctypes, ops/_build.py): pointers and the stream arrive as
// void*; the launcher returns cudaGetLastError().

#include "local_sw.cuh"

namespace {

template <int G, int C>
__global__ void __launch_bounds__(sw::kThreads)
    local_align6_kernel(const int32_t* __restrict__ q, int qmax,
                        const int32_t* __restrict__ qlen,
                        const int32_t* __restrict__ t, int tmax,
                        const int32_t* __restrict__ tlen, int64_t B,
                        const int32_t* __restrict__ mat,
                        const int32_t* __restrict__ pens,
                        int32_t* __restrict__ out, unsigned char* scratch,
                        int64_t slot_bytes) {
  sw::local_align6_body<G, C>(q, qmax, qlen, t, tmax, tlen, B, mat, pens, out,
                              scratch, slot_bytes);
}

struct Launch {
  const int32_t *q, *qlen, *t, *tlen, *mat, *pens;
  int qmax, tmax;
  int64_t B;
  int32_t* out;
  unsigned char* scratch;
  cudaStream_t stream;

  template <int G, int C>
  int run() const {
    const int64_t slot = sw::local_slot_bytes<G, C>(qmax, tmax);
    unsigned blocks;
    int64_t bytes;
    sw::launch_grid<G>(B, slot, &blocks, &bytes);
    local_align6_kernel<G, C><<<blocks, sw::kThreads, 0, stream>>>(
        q, qmax, qlen, t, tmax, tlen, B, mat, pens, out, scratch, slot);
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
    sw::launch_grid<G>(B, sw::local_slot_bytes<G, C>(qmax, tmax), &blocks,
                       &bytes);
    return bytes;
  }
};

}  // namespace

extern "C" {

// Bytes of device scratch that bwt_local_align6 needs for these shapes.
long long bwt_local_align6_scratch(int qmax, int tmax, long long B) {
  return sw::dispatch_sw(qmax, Scratch{qmax, tmax, (int64_t)B});
}

// The whole ksw_align of B tasks on `stream`: q (B, qmax), t (B, tmax),
// qlen, tlen (B,), mat (5, 5), pens (4,) int32; out (6, B) int32; scratch
// of bwt_local_align6_scratch bytes.  Returns cudaGetLastError().
int bwt_local_align6(const void* q, int qmax, const void* qlen,
                     const void* t, int tmax, const void* tlen, long long B,
                     const void* mat, const void* pens, void* out,
                     void* scratch, void* stream) {
  if (B <= 0) return 0;
  const Launch l{static_cast<const int32_t*>(q),
                 static_cast<const int32_t*>(qlen),
                 static_cast<const int32_t*>(t),
                 static_cast<const int32_t*>(tlen),
                 static_cast<const int32_t*>(mat),
                 static_cast<const int32_t*>(pens),
                 qmax, tmax, (int64_t)B, static_cast<int32_t*>(out),
                 static_cast<unsigned char*>(scratch),
                 static_cast<cudaStream_t>(stream)};
  return sw::dispatch_sw(qmax, l);
}

}  // extern "C"
