"""bwamem_tpu_torch — the PyTorch/CUDA port of the bwamem_tpu aligner.

The port sits beside the JAX package (`bwamem_tpu`, the reference) and
reuses its JAX-free host half as it is: FASTA/FASTQ I/O, the FM-index,
and the native C++ pipeline (`bwamem_tpu.pipeline.native_driver.
NativePipeline` over csrc/mempipe.cpp) that seeds, chains, plans,
replays, pairs and writes SAM.  What the port replaces is the device
half:

  ops/types.py        ExtendParams / ExtendOut and the scoring vector
  ops/extend_torch.py plain PyTorch banded extension (the CPU path and
                      the oracle the kernels are held to)
  ops/extend_cuda.py  the hand-written Hopper kernels: the fused
                      four-pass extension (csrc/extend_fused.cu) and the
                      per-phase one-pass extension (csrc/extend_t.cu)
  ops/extend.py       the Python host's batched extension backend
  pipeline/resident.py  the device-resident two-strand reference, the
                      window gathers and the fused_idx backend that
                      NativePipeline drives
  pipeline/native_driver.py  the per-phase (--phased) and host-shipped
                      fused (--ship-ref) backends for NativePipeline
  pipeline/driver.py, pipeline/pair.py  the Python host (--host python)
                      without the reference driver's JAX calls
  __main__.py         `python -m bwamem_tpu_torch index|mem|merge`

Nothing here imports JAX.  The device is always passed in explicitly.
"""

__version__ = "0.1.0"
