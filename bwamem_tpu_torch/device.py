"""Explicit device selection: the port never picks a device silently."""

from __future__ import annotations

import numpy as np
import torch


def resolve(name) -> torch.device:
    """The torch.device for `name` ("cuda", "cuda:0", "cpu", or a
    torch.device).  Raises when a CUDA device is asked for and
    torch.cuda.is_available() is False — there is no CPU fallback."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is "
            "False")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def to_device(x, dtype, device) -> torch.Tensor:
    """The array `x` as a contiguous tensor of numpy type `dtype` on
    `device` (one host-to-device copy when that is a GPU)."""
    return torch.from_numpy(np.ascontiguousarray(x, dtype)).to(device)
