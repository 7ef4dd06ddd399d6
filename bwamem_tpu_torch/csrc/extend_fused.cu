// Fused whole-alignment seed extension for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _extend_kernel_fused (with its row loop
// _band_pass) in bwamem_tpu/ops/extend_pallas.py.  Per alignment it runs
// four banded ksw_extend2 passes: L0; the L1 band-doubling retry where
// max_off >= (w>>1)+(w>>2); R0 seeded with the left score; the R1 retry
// under the same rule.  Output (32, B) int32 = [L0 | L1 | R0 | R1] x
// [score, qle, tle, gtle, gscore, max_off, aw, 0], bit-identical to the
// Pallas kernel and to the plain PyTorch version (ops/extend_torch.py).
//
// Design: a group of cooperating threads per alignment runs the four
// passes in turn, each the shared pass of band_pass.cuh (strips of query
// columns per thread, the H/E row in registers or shared memory, F as a
// scan), so the left score seeds the right pass without leaving the
// group.  The four passes are one loop around one copy of the pass body.
// The group width and the strip length are template parameters chosen at
// launch from the wider of the two query windows.  What bounds it is
// integer throughput, not bytes.  The per-block row bounds (tmax2) are
// not needed: each alignment stops at its own tlen, so results cannot
// depend on them.
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
__global__ void __launch_bounds__(kThreads) extend_fused_kernel(
    const int8_t* __restrict__ ql, int QL, const int8_t* __restrict__ tl,
    int TL, const int8_t* __restrict__ qr, int QR,
    const int8_t* __restrict__ tr, int TR, const int32_t* __restrict__ scal,
    int64_t B, Prm p, int* __restrict__ out, int ncol) {
  extern __shared__ __align__(16) unsigned char smem[];
  extend_fused_body<G, C>(ql, QL, tl, TL, qr, QR, tr, TR, scal, B, p, out,
                          ncol, smem);
}

struct LaunchFused {
  const int8_t *ql, *tl, *qr, *tr;
  int QL, TL, QR, TR;
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
    launch_shape<G, C>(B, QL > QR ? QL : QR, &blocks, &ncol, &smem);
    extend_fused_kernel<G, C><<<blocks, kThreads, smem, stream>>>(
        ql, QL, tl, TL, qr, QR, tr, TR, scal, B, p, out, ncol);
    return (int)cudaGetLastError();
  }
};

}  // namespace

extern "C" {

// Launch the fused kernel on `stream`.  Windows are int8 (QL|TL|QR|TR, B)
// row-major with QL, QR <= 1024, scal (16, B) int32, out (32, B) int32.
// Returns cudaGetLastError().
int bwt_extend_fused(const void* ql, int QL, const void* tl, int TL,
                     const void* qr, int QR, const void* tr, int TR,
                     const void* scal, long long B, int a, int b, int o_del,
                     int e_del, int o_ins, int e_ins, int zdrop, void* out,
                     void* stream) {
  if (B <= 0) return 0;
  const LaunchFused l{static_cast<const int8_t*>(ql),
                      static_cast<const int8_t*>(tl),
                      static_cast<const int8_t*>(qr),
                      static_cast<const int8_t*>(tr),
                      QL, TL, QR, TR,
                      static_cast<const int32_t*>(scal), (int64_t)B,
                      Prm{a, b, o_del, e_del, o_ins, e_ins, zdrop},
                      static_cast<int*>(out),
                      static_cast<cudaStream_t>(stream)};
  return dispatch_shape(QL > QR ? QL : QR, l);
}

const char* bwt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
