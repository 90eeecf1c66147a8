"""Carry the reference's parameters and caches into the port.

The reference's trees, as numpy arrays (``np.asarray`` of each jax
leaf), become tensors key for key.  A bf16 leaf arrives as numpy
``bfloat16`` (the ml_dtypes type), which ``torch.from_numpy`` refuses;
it crosses as its 16-bit pattern and is viewed back as
``torch.bfloat16``, bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from ..tree import tree_map


def tensor_from_numpy(a, device) -> torch.Tensor:
    """One leaf, copied (the tensor never shares the array's memory)."""
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_numpy(tree, device):
    """The reference's parameter tree (numpy leaves) -> the port's."""
    return tree_map(lambda a: tensor_from_numpy(a, device), tree)


def cache_from_numpy(cache, device):
    """The reference's KV cache ({"slot0": (k, v)}, numpy leaves) -> the
    port's, stacked on the same superblock axis."""
    return tree_map(lambda a: tensor_from_numpy(a, device), cache)
