// Fused whole-alignment seed extension for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _extend_kernel_fused (with its row loop
// _band_pass) in bwamem_tpu/ops/extend_pallas.py.  Per lane it runs four
// banded ksw_extend2 passes: L0; the L1 band-doubling retry where
// max_off >= (w>>1)+(w>>2); R0 seeded with the left score; the R1 retry
// under the same rule.  Output (32, B) int32 = [L0 | L1 | R0 | R1] x
// [score, qle, tle, gtle, gscore, max_off, aw, 0], bit-identical to the
// Pallas kernel and to the plain PyTorch version (ops/extend_torch.py).
//
// Design: one thread per lane runs the four passes in turn, each the
// shared scalar pass of band_pass.cuh (ksw_extend_core's recurrence with
// the eh row in a global (qmax+2, B) scratch).  What bounds this version
// is scratch traffic and memory latency (few warps per SM at B = 8192
// lanes), not arithmetic.  The per-block row bounds (tmax2) are not
// needed: each thread stops at its own tlen, so results cannot depend on
// them.
//
// Plain C interface (built with nvcc into a shared library, loaded with
// ctypes): pointers and the stream arrive as void*, and the launcher
// returns cudaGetLastError().

#include "band_pass.cuh"

namespace {

__global__ void extend_fused_kernel(
    const int8_t* __restrict__ ql, int QL, const int8_t* __restrict__ tl,
    int TL, const int8_t* __restrict__ qr, int QR,
    const int8_t* __restrict__ tr, int TR, const int32_t* __restrict__ scal,
    int64_t B, Prm p, int* __restrict__ out, int* eh_h, int* eh_e) {
  const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  const int qlen_l = scal[0 * B + lane], tlen_l = scal[1 * B + lane];
  const int aw0_l = scal[2 * B + lane], h0_seed = scal[3 * B + lane];
  const int aw1_l = scal[4 * B + lane];
  const int qlen_r = scal[5 * B + lane], tlen_r = scal[6 * B + lane];
  const int aw0_r = scal[7 * B + lane], aw1_r = scal[8 * B + lane];
  const int w = scal[9 * B + lane];
  const int thr = (w >> 1) + (w >> 2);

  const PassOut l0 = band_pass(ql, QL, tl, TL, B, lane, qlen_l, tlen_l,
                               aw0_l, h0_seed, true, eh_h, eh_e, p);
  emit(out, B, lane, 0, l0, aw0_l);
  const bool conv_l = l0.max_off < thr;
  const PassOut l1 = band_pass(ql, QL, tl, TL, B, lane, qlen_l, tlen_l,
                               aw1_l, h0_seed, !conv_l, eh_h, eh_e, p);
  emit(out, B, lane, 8, l1, aw1_l);
  // lanes with no left task fall through to h0_seed (best = h0)
  const int h0_r = conv_l ? l0.best : l1.best;
  const PassOut r0 = band_pass(qr, QR, tr, TR, B, lane, qlen_r, tlen_r,
                               aw0_r, h0_r, true, eh_h, eh_e, p);
  emit(out, B, lane, 16, r0, aw0_r);
  const bool conv_r = r0.max_off < thr;
  const PassOut r1 = band_pass(qr, QR, tr, TR, B, lane, qlen_r, tlen_r,
                               aw1_r, h0_r, !conv_r, eh_h, eh_e, p);
  emit(out, B, lane, 24, r1, aw1_r);
}

}  // namespace

extern "C" {

// Launch the fused kernel on `stream`.  Windows are int8 (QL|TL|QR|TR, B)
// row-major, scal (16, B) int32, out (32, B) int32, eh_h/eh_e
// (max(QL, QR) + 2, B) int32 scratch.  Returns cudaGetLastError().
int bwt_extend_fused(const void* ql, int QL, const void* tl, int TL,
                     const void* qr, int QR, const void* tr, int TR,
                     const void* scal, long long B, int a, int b, int o_del,
                     int e_del, int o_ins, int e_ins, int zdrop, void* out,
                     void* eh_h, void* eh_e, void* stream) {
  if (B <= 0) return 0;
  const Prm p{a, b, o_del, e_del, o_ins, e_ins, zdrop};
  const int threads = 64;
  const long long blocks = (B + threads - 1) / threads;
  extend_fused_kernel<<<(unsigned)blocks, threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(ql), QL, static_cast<const int8_t*>(tl), TL,
      static_cast<const int8_t*>(qr), QR, static_cast<const int8_t*>(tr), TR,
      static_cast<const int32_t*>(scal), (int64_t)B, p,
      static_cast<int*>(out), static_cast<int*>(eh_h),
      static_cast<int*>(eh_e));
  return (int)cudaGetLastError();
}

const char* bwt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
