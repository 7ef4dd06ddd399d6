"""bwamem_tpu_torch — the PyTorch/CUDA port of the bwamem_tpu aligner.

The port sits beside the JAX package (`bwamem_tpu`, the reference) and
stands on its own: it imports torch and numpy, never JAX and nothing of
the JAX package.  Modules keep the JAX package's paths and names, so a
module's counterpart is found by its path.

Host half, the port's own copies of the reference's JAX-free modules:

  config.py           MemOptions, build_mat
  io/                 FASTA, FASTQ, SAM
  native/             the ctypes loader of the C++ host (csrc/*.cpp at
                      the repository's root, with the port's own
                      mempipe.cpp), built into bwamem_tpu_torch/build/
  index/              FM-index build, packed Occ, batched SMEM
  ops/extend_ref.py, ops/local_ref.py  the scalar bwa-0.7.8 oracles
  pipeline/{tasks,wire,cigar,chain,align}.py
  pipeline/driver.py, pipeline/pair.py  the Python host (--host python)
  pipeline/native_driver.py  NativePipeline over native/mempipe.cpp, the
                      per-phase (--phased) and host-shipped fused
                      (--ship-ref) backends, the resident-text packing
  utils/, parallel/multihost.py  trace, checkpoint, read sharding

Device half, what the port replaces:

  ops/types.py        ExtendParams / ExtendOut and the scoring vector
  ops/extend_torch.py plain PyTorch banded extension (the CPU path and
                      the oracle the kernels are held to)
  ops/extend_cuda.py  the hand-written Hopper kernels: the fused
                      four-pass extension (csrc/extend_fused.cu) and the
                      per-phase one-pass extension (csrc/extend_t.cu)
                      over one pass body (csrc/band_pass.cuh)
  ops/extend.py       the Python host's batched extension backend
  pipeline/resident.py  the device-resident two-strand reference, the
                      window gathers and the fused_idx backend that
                      NativePipeline drives
  __main__.py         `python -m bwamem_tpu_torch index|mem|merge`

The device is always passed in explicitly.
"""

__version__ = "0.1.0"
