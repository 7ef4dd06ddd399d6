"""The interfaces of the port's copied host modules against the JAX
package's: for each copied module, every public function and class the
reference module defines (not one it imports), and every public method
of such a class, exists in the port's copy with the same
inspect.signature (parameter names, kinds and defaults; a default that
is a function or a class is compared by its qualified name within its
package).  What the port does otherwise is listed below, each with its
reason and, where the port has a counterpart elsewhere, its place; the
test also checks that each listed difference still is one and that its
counterpart exists."""

import importlib
import inspect

import pytest
import torch

torch.set_num_threads(1)

# copied module: {name the port's copy lacks or declares otherwise:
#                 (reason, counterpart "module:name" or None)}
COPIES = {
    "config": {},
    "io.fasta": {},
    "io.fastq": {
        "iter_fastq_chunks": (
            "tracer= times the stream's reads and the parsing as spans "
            "(utils.metrics.Tracer); the JAX package's CLI traces no input; "
            "the chunks are ReadBatches (columns, a sequence of Read), "
            "the JAX package's lists of Read", "io.fastq:ReadBatch"),
    },
    "io.sam": {},
    "native": {},
    "index.build": {},
    "index.fmindex": {},
    "index.occ_packed": {},
    "index.smem_batch": {},
    "ops.extend_ref": {},
    "ops.local_ref": {},
    "pipeline.tasks": {},
    "pipeline.wire": {},
    "pipeline.cigar": {},
    "pipeline.chain": {},
    "pipeline.align": {},
    "pipeline.driver": {
        "align_batch": (
            "device= names the torch.device of --device-cigar's batched "
            "rounds (ops/global_torch); the JAX package places them on its "
            "default device", None),
    },
    "pipeline.pair": {},
    "pipeline.native_driver": {
        "make_raw_t_backend": (
            "the per-phase backend takes a torch.device and a cell type "
            "(compute_dtype); Pallas's interpret mode has no counterpart",
            "pipeline.native_driver:make_raw_t_backend"),
        "make_fused_backend": (
            "the ship-ref fused backend takes a torch.device and a cell "
            "type; no interpret mode", "pipeline.native_driver:"
            "make_fused_backend"),
        "make_jax_raw_t_backend": (
            "the extend_jax twin's backend: the port's plain version is "
            "make_raw_t_backend on the CPU",
            "pipeline.native_driver:make_raw_t_backend"),
        "make_resident_text": (
            "the resident reference lives in pipeline/resident.py, on a "
            "torch.device", "pipeline.resident:make_resident_text"),
        "fused_idx_local": ("pipeline/resident.py",
                            "pipeline.resident:fused_idx_local"),
        "make_fused_idx_backend": ("pipeline/resident.py, with a device",
                                   "pipeline.resident:make_fused_idx_backend"),
        "rescue_idx_local": ("pipeline/resident.py",
                             "pipeline.resident:rescue_idx_local"),
        "make_rescue_idx_backend": (
            "pipeline/resident.py, with a device",
            "pipeline.resident:make_rescue_idx_backend"),
        "cigar_idx_local": ("pipeline/resident.py",
                            "pipeline.resident:cigar_idx_local"),
        "make_cigar_idx_backend": (
            "pipeline/resident.py, with a device",
            "pipeline.resident:make_cigar_idx_backend"),
    },
    "utils.metrics": {
        "Counters": (
            "no device_seconds / host_seconds (only gcups and "
            "reads_per_sec divided them); h2d_bytes counts the resident "
            "backends' copies in", None),
        "Counters.gcups": (
            "divided by the device call's host wall time, not the "
            "kernel's: read by nothing", None),
        "Counters.reads_per_sec": (
            "summed overlapping threads' seconds: read by nothing; the "
            "CLI's `[mem] align:` line gives the rate", None),
        "Tracer.batch": (
            "a device call's row is a span opened around the call, "
            "stamped at its start and end", "utils.metrics:span"),
        "Tracer.host": (
            "a host_chunk row is a span opened around the chunk's host "
            "work", "utils.metrics:span"),
    },
    "utils.checkpoint": {},
    "parallel.multihost": {
        "init_distributed": (
            "torch.distributed: the rank, world size and address come from "
            "the environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT), "
            "where jax.distributed takes them as arguments", None),
    },
    "__main__": {
        "make_extend_backend": (
            "the Python host's backend comes from make_backends, on the "
            "device mem_device picks", "__main__:make_backends"),
        "make_raw_t_backend": (
            "the native host's backends come from make_backends",
            "__main__:make_backends"),
    },
}


def _default(v):
    if v is inspect.Parameter.empty:
        return "<empty>"
    if callable(v) and hasattr(v, "__qualname__"):
        v = f"<{v.__module__}.{v.__qualname__}>"
    return repr(v).replace("bwamem_tpu_torch", "bwamem_tpu")


def _signature(obj):
    try:
        sig = inspect.signature(obj)
    except (TypeError, ValueError):
        return None
    return [(p.name, p.kind, _default(p.default))
            for p in sig.parameters.values()]


def _interface(mod):
    """{public name: signature} of the functions and classes `mod`
    defines, and of the public methods of those classes ("Class.meth")."""
    out = {}
    for name, obj in vars(mod).items():
        if name.startswith("_") or getattr(obj, "__module__", None) \
                != mod.__name__:
            continue
        if not (inspect.isfunction(obj) or inspect.isclass(obj)):
            continue
        out[name] = _signature(obj)
        if inspect.isclass(obj):
            for meth, f in vars(obj).items():
                if not meth.startswith("_") and inspect.isfunction(f):
                    out[f"{name}.{meth}"] = _signature(f)
    return out


def _port(path):
    mod, _, name = path.partition(":")
    obj = importlib.import_module("bwamem_tpu_torch." + mod)
    return getattr(obj, name)


@pytest.mark.parametrize("module", sorted(COPIES))
def test_copy_keeps_the_interface(module):
    ref = _interface(importlib.import_module("bwamem_tpu." + module))
    port = _interface(importlib.import_module("bwamem_tpu_torch." + module))
    known = COPIES[module]
    assert ref, f"bwamem_tpu.{module} defines nothing public"
    differ = {k for k in ref if port.get(k, "missing") != ref[k]}
    assert differ == set(known), (
        f"{module}: differences {sorted(differ)}, listed {sorted(known)}")
    for name, (reason, where) in known.items():
        assert reason
        if where is not None:
            assert callable(_port(where)), where
