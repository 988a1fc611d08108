"""Constant tensors built once per (value, dtype, device).

`torch.tensor(python_value, device="cuda")` copies from pageable host memory
and waits for the stream on every call, which a CUDA graph capture refuses.
The models and control modules take their constants from here instead: the
first call builds the tensor, later calls return the same one. Callers must
not write into a returned tensor.
"""

from __future__ import annotations

import numpy as np
import torch

_CACHE: dict = {}


def const(value, dtype: torch.dtype, device) -> torch.Tensor:
    """`value` as a tensor in `dtype` on `device`. A tensor is converted
    (`Tensor.to`); a number, a nested sequence of numbers or a numpy array is
    built once, keyed by its float64 bytes (so 0.0 and -0.0 are two
    constants)."""
    if torch.is_tensor(value):
        return value.to(device=device, dtype=dtype)
    device = torch.get_default_device() if device is None else torch.device(device)
    a = np.asarray(value, np.float64)
    key = (a.shape, a.tobytes(), dtype, device)
    t = _CACHE.get(key)
    if t is None:
        t = _CACHE[key] = torch.tensor(a, dtype=dtype, device=device)
    return t
