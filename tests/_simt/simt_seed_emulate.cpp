// Runs the seeding kernels of bwamem_tpu_torch/csrc/fm_seed.cu on the CPU,
// compiled by g++ against the stand-in cuda_runtime.h beside this file:
//
//   g++ -O2 -std=c++17 -shared -fPIC -I tests/_simt -I bwamem_tpu_torch/csrc
//       -o libsimt_seed.so tests/_simt/simt_seed_emulate.cpp
//
// fm_seed.cu is included whole, so the library exports its own C launchers
// (bwt_smem_all, bwt_smem1, bwt_sa, and the _sh entries) with their
// arguments unpacked as on the card; only FM_LAUNCH, the launch itself, is
// this file's.  It runs the grid a real launch would: every block, and in
// each block every warp as 32 fibers (simt_fibers.h) with the thread
// indices the card gives them, so the warp collectives of smem1_warp run
// as they do there.  A group that returns early (a read or a row past the
// end) hands over to the next fiber.  Results must equal the plain PyTorch
// version's: tests/test_torch_simt_seed.py.

#include "simt_fibers.h"

namespace simt_seed {

// Every block of a grid of `blocks` blocks of `threads` threads runs
// body() in each thread, a warp of 32 fibers at a time.
template <class Body>
void run_grid(unsigned blocks, unsigned threads, Body& body) {
  gridDim.x = blocks;
  blockDim.x = threads;
  for (unsigned blk = 0; blk < blocks; ++blk) {
    blockIdx.x = blk;
    for (unsigned base = 0; base < threads; base += 32)
      simt::run_group(
          32, base, [](void* a) { (*static_cast<Body*>(a))(); }, &body);
  }
}

}  // namespace simt_seed

#define FM_LAUNCH(kernel, n, per_block, threads, stream, ...)              \
  do {                                                                     \
    (void)(stream);                                                        \
    if ((n) <= 0) return 0;                                                \
    auto fm_body = [&]() { kernel(__VA_ARGS__); };                         \
    simt_seed::run_grid((unsigned)(((n) + (per_block) - 1) / (per_block)), \
                        (unsigned)(threads), fm_body);                     \
    return 0;                                                              \
  } while (0)

#include "fm_seed.cu"
