"""Carry the reference's parameters and caches into the port.

The reference's trees, as numpy arrays (``np.asarray`` of each jax
leaf), become tensors key for key, whatever the family: the dense
attention and MLP leaves, the encoder-decoder's stacked ``enc_blocks``
and ``dec_blocks`` (self- and cross-attention, norms, MLPs) beside its
``ln_enc``, MLA's projections and norms, the MoE's (E, d, f) expert
stacks, its float32 ``router`` and its ``shared`` expert, the
recurrent mixers' leaves (Mamba's float32 ``A_log`` and ``D``, the
xLSTM cells' float32 gate weights and biases, each leaf in its own
dtype), and the caches (K and V, the encoder-decoder's {"self": (k, v),
"cross": (k, v)}, MLA's latent and rotary key, Mamba's conv state and
float32 ``h``, the xLSTM cells' float32 states).  A bf16 leaf arrives as
numpy ``bfloat16`` (the ml_dtypes type), which ``torch.from_numpy``
refuses; it crosses as its 16-bit pattern and is viewed back as
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
    """The reference's decode cache ({"slot0": (k, v)}, (c_kv, k_rope)
    for MLA, a recurrent mixer's state tuple, the encoder-decoder's
    {"self": (k, v), "cross": (k, v)}; numpy leaves) -> the port's,
    stacked on the same superblock (or layer) axis.  Every leaf is a copy,
    so the reference's sLSTM cache, one array used three times, arrives
    as separate tensors."""
    return tree_map(lambda a: tensor_from_numpy(a, device), cache)
