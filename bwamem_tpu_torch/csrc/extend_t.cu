// Per-phase seed extension for Hopper (sm_90a): one banded ksw_extend2
// pass per alignment.
//
// Replaces the Pallas TPU kernel _extend_kernel_t (with its row loop
// _band_pass) in bwamem_tpu/ops/extend_pallas.py, which the native
// host's four-pass protocol (L0, L retry, R0, R retry as four launches)
// and the Python host's batched driver call.  Input scal (8, B) int32 =
// [qlen, tlen, aw, h0, 0...]; output (8, B) int32 = [score, qle, tle,
// gtle, gscore, max_off, aw, 0], bit-identical to the Pallas kernel and
// to the plain PyTorch version (ops/extend_torch.extend_t).
//
// Design: a group of cooperating threads per alignment runs the shared
// pass of band_pass.cuh (strips of query columns per thread, the H/E row
// in registers or shared memory, F as a scan), as extend_fused.cu does
// four times over.  The group width and the strip length are template
// parameters chosen at launch from the query window.  What bounds it is
// integer throughput, not bytes.  Two contracts:
// - The per-block row bounds (the Pallas call's `tmax`) are not read:
//   each alignment stops at its own tlen.  This equals the Pallas result
//   whenever each bound is >= the tlen of every valid lane of its block,
//   which is how every caller computes it.
// - The Pallas kernel's `early_exit` switch is not carried: it changes
//   only which masked rows run, never an output.
//
// Plain C interface (built with nvcc into a shared library, loaded with
// ctypes): pointers and the stream arrive as void*, and the launcher
// returns cudaGetLastError().

// PTX prmt.b32 in its default mode, for band_pass.cuh: byte n of the result
// is byte s[4n+2:4n] of {y, x}, or that byte's sign over all 8 bits where
// s[4n+3] is set.
static __device__ __forceinline__ unsigned prmt_b32(unsigned x, unsigned y,
                                                    unsigned s) {
  unsigned d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(x), "r"(y), "r"(s));
  return d;
}

#include "band_pass.cuh"

namespace {

template <int G, int C>
__global__ void __launch_bounds__(kThreads)
    extend_t_kernel(const int8_t* __restrict__ q, int qmax,
                    const int8_t* __restrict__ t, int tmax,
                    const int32_t* __restrict__ scal, int64_t B, Prm p,
                    int* __restrict__ out, int ncol) {
  extern __shared__ __align__(16) unsigned char smem[];
  extend_t_body<G, C>(q, qmax, t, tmax, scal, B, p, out, ncol, smem);
}

struct LaunchT {
  const int8_t* q;
  int qmax;
  const int8_t* t;
  int tmax;
  const int32_t* scal;
  int64_t B;
  Prm p;
  int* out;
  cudaStream_t stream;

  template <int G, int C>
  int run() const {
    unsigned blocks;
    int ncol;
    size_t smem;
    launch_shape<G, C>(B, qmax, &blocks, &ncol, &smem);
    extend_t_kernel<G, C><<<blocks, kThreads, smem, stream>>>(
        q, qmax, t, tmax, scal, B, p, out, ncol);
    return (int)cudaGetLastError();
  }
};

}  // namespace

extern "C" {

// Launch the per-phase kernel on `stream`.  Windows are int8 (qmax, B)
// and (tmax, B) row-major with qmax <= 1024, scal (8, B) int32, out
// (8, B) int32.  Returns cudaGetLastError().
int bwt_extend_t(const void* q, int qmax, const void* t, int tmax,
                 const void* scal, long long B, int a, int b, int o_del,
                 int e_del, int o_ins, int e_ins, int zdrop, void* out,
                 void* stream) {
  if (B <= 0) return 0;
  const LaunchT l{static_cast<const int8_t*>(q), qmax,
                  static_cast<const int8_t*>(t), tmax,
                  static_cast<const int32_t*>(scal), (int64_t)B,
                  Prm{a, b, o_del, e_del, o_ins, e_ins, zdrop},
                  static_cast<int*>(out), static_cast<cudaStream_t>(stream)};
  return dispatch_shape(qmax, l);
}

}  // extern "C"
