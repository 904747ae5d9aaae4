"""Carry parameters and optimizer state between the JAX package and the port.

The caller converts a JAX pytree to numpy (``jax.tree.map(np.asarray,
tree)``); ``params_from_numpy`` turns that tree of numpy arrays into the
port's tree of tensors, same keys, same layouts: ``None`` (the optimizer's
``err`` before gradient compression fills it) stays ``None``, and a 0-d array
(its ``step``) becomes a 0-d tensor of the same dtype. The trees have
the JAX model's shapes at whatever tensor-parallel layout it was built for
(``ParallelConfig.tp``: packed GQA slots, padded vocab and experts), which a
port model built with the same ``pc`` has by construction. bfloat16 arrays (numpy
dtype name ``bfloat16``, from ml_dtypes) pass through a ``uint16`` view, so
the bits carry over exactly; ``numpy_from_tensor`` goes the other way (bf16
to a ``uint16`` view, as the checkpoint files store it). This module imports
neither jax nor ml_dtypes.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch


def tensor_from_numpy(arr: np.ndarray, device=None) -> torch.Tensor:
    arr = np.array(arr, order="C")       # a copy; a 0-d array stays 0-d
    if arr.dtype.name == "bfloat16":
        out = torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    else:
        out = torch.from_numpy(arr)
    return out.to(device) if device is not None else out


def numpy_from_tensor(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t``; bfloat16 comes back as its raw ``uint16`` bits."""
    t = t.detach().to("cpu").contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def params_from_numpy(tree: Any, device: Optional[torch.device] = None) -> Any:
    """Nested dict of numpy arrays -> nested dict of tensors on ``device``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return tensor_from_numpy(np.asarray(tree), device)
