// Per-phase seed extension for Hopper (sm_90a): one banded ksw_extend2
// pass per lane.
//
// Replaces the Pallas TPU kernel _extend_kernel_t (with its row loop
// _band_pass) in bwamem_tpu/ops/extend_pallas.py, which the native
// host's four-pass protocol (L0, L retry, R0, R retry as four launches)
// and the Python host's batched driver call.  Input scal (8, B) int32 =
// [qlen, tlen, aw, h0, 0...]; output (8, B) int32 = [score, qle, tle,
// gtle, gscore, max_off, aw, 0], bit-identical to the Pallas kernel and
// to the plain PyTorch version (ops/extend_torch.extend_t).
//
// Design: one thread per lane runs the shared scalar pass of
// band_pass.cuh, as extend_fused.cu does four times over.  What bounds it
// is scratch traffic and memory latency, not arithmetic.  Two contracts:
// - The per-block row bounds (the Pallas call's `tmax`) are not read:
//   each thread stops at its own tlen.  This equals the Pallas result
//   whenever each bound is >= the tlen of every valid lane of its block,
//   which is how every caller computes it.
// - The Pallas kernel's `early_exit` switch is not carried: it changes
//   only which masked rows run, never an output.
//
// Plain C interface (built with nvcc into a shared library, loaded with
// ctypes): pointers and the stream arrive as void*, and the launcher
// returns cudaGetLastError().

#include "band_pass.cuh"

namespace {

__global__ void extend_t_kernel(const int8_t* __restrict__ q, int qmax,
                                const int8_t* __restrict__ t, int tmax,
                                const int32_t* __restrict__ scal, int64_t B,
                                Prm p, int* __restrict__ out, int* eh_h,
                                int* eh_e) {
  const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  const int qlen = scal[0 * B + lane], tlen = scal[1 * B + lane];
  const int aw = scal[2 * B + lane], h0 = scal[3 * B + lane];
  const PassOut r = band_pass(q, qmax, t, tmax, B, lane, qlen, tlen, aw, h0,
                              true, eh_h, eh_e, p);
  emit(out, B, lane, 0, r, aw);
}

}  // namespace

extern "C" {

// Launch the per-phase kernel on `stream`.  Windows are int8 (qmax, B)
// and (tmax, B) row-major, scal (8, B) int32, out (8, B) int32,
// eh_h/eh_e (qmax + 2, B) int32 scratch.  Returns cudaGetLastError().
int bwt_extend_t(const void* q, int qmax, const void* t, int tmax,
                 const void* scal, long long B, int a, int b, int o_del,
                 int e_del, int o_ins, int e_ins, int zdrop, void* out,
                 void* eh_h, void* eh_e, void* stream) {
  if (B <= 0) return 0;
  const Prm p{a, b, o_del, e_del, o_ins, e_ins, zdrop};
  const int threads = 64;
  const long long blocks = (B + threads - 1) / threads;
  extend_t_kernel<<<(unsigned)blocks, threads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), qmax, static_cast<const int8_t*>(t),
      tmax, static_cast<const int32_t*>(scal), (int64_t)B, p,
      static_cast<int*>(out), static_cast<int*>(eh_h),
      static_cast<int*>(eh_e));
  return (int)cudaGetLastError();
}

}  // extern "C"
