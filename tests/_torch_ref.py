"""Helpers for the tests that hold the port's copied host modules to the
JAX package's: the port's extension pass on the CPU as the Python host's
`extend_batch_fn` (where the JAX package's tests pass the extend_jax
twin), each call recorded, and the check of recorded calls against the
JAX function on the same inputs.  Imports the JAX package, so neither
the port nor chip_smoke.py may import it (tests/_torch_gate.py is the
helper they share)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

import jax.numpy as jnp

from bwamem_tpu.ops import extend_jax
from bwamem_tpu_torch.ops import extend, types

CPU = torch.device("cpu")


def jax_params(opt):
    """The JAX package's ExtendParams of a MemOptions of either package."""
    return extend_jax.ExtendParams(
        mat_flat=jnp.asarray(np.asarray(opt.mat, np.int32).ravel()), m=5,
        o_del=opt.o_del, e_del=opt.e_del, o_ins=opt.o_ins, e_ins=opt.e_ins,
        zdrop=opt.zdrop)


def port_extend_fn(opt):
    """ops/extend.extend_batch_core on the CPU with the scoring of `opt`,
    as an extend_batch_fn(query, qlen, target, tlen, aw, h0); every call's
    arguments and result are kept in .calls."""
    params = types.params_from_options(opt)

    def fn(*args):
        out = extend.extend_batch_core(*args, params, device=CPU)
        fn.calls.append((args, out))
        return out

    fn.calls = []
    return fn


def check_against_jax(fn, opt, n_calls: int = 1) -> int:
    """The first n_calls calls recorded by a port_extend_fn, run again
    through extend_jax.extend_batch_core on the same inputs: every field
    of every task equal.  Returns the number of tasks compared (> 0)."""
    assert fn.calls, "the extension was never called"
    params = jax_params(opt)
    tasks = 0
    for args, got in fn.calls[:n_calls]:
        want = extend_jax.extend_batch_core(
            *(jnp.asarray(np.asarray(a)) for a in args), params)
        for name in types.ExtendOut._fields:
            np.testing.assert_array_equal(
                np.asarray(getattr(got, name)),
                np.asarray(getattr(want, name)), err_msg=name)
        tasks += len(np.asarray(args[1]))
    assert tasks > 0
    return tasks


def ref_options(opt):
    """The JAX package's MemOptions with the fields of the port's `opt`."""
    from bwamem_tpu.config import MemOptions

    return MemOptions(**{f.name: getattr(opt, f.name)
                         for f in dataclasses.fields(opt) if f.init})
