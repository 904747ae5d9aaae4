"""Carry parameters across from the JAX package to the port.

The caller converts the JAX param pytree to numpy (``jax.tree.map(np.asarray,
params)``); ``params_from_numpy`` turns that tree of numpy arrays into the
port's tree of tensors, same keys, same layouts. bfloat16 arrays (numpy dtype
name ``bfloat16``, from ml_dtypes) pass through a ``uint16`` view, so the bits
carry over exactly; this module imports neither jax nor ml_dtypes.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch


def tensor_from_numpy(arr: np.ndarray, device=None) -> torch.Tensor:
    arr = np.ascontiguousarray(arr)
    if arr.dtype.name == "bfloat16":
        out = torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        out = torch.from_numpy(arr.copy())
    return out.to(device) if device is not None else out


def params_from_numpy(tree: Any, device: Optional[torch.device] = None) -> Any:
    """Nested dict of numpy arrays -> nested dict of tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return tensor_from_numpy(np.asarray(tree), device)
