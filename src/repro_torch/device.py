"""Device resolution for the port's entry points.

Every entry point (``ReStore``, ``Engine``, ``ArtifactStore``,
``Catalog``, ``Table.from_numpy``, the PigMix generators) takes
``device=None``, which resolves here to the CUDA card.  There is no
silent CPU fallback: without a card, ``None`` raises, and the CPU is
used only when a caller passes ``device="cpu"`` explicitly.
"""
from __future__ import annotations

import torch


def default_device() -> torch.device:
    """The CUDA card; raises when this process sees none."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: no CUDA device is visible; pass device='cpu' "
            "to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def resolve(device=None) -> torch.device:
    """``None`` -> ``default_device()``; anything else -> torch.device,
    with a bare ``"cuda"`` pinned to the current card's index so device
    comparisons between tables, stores and engines are exact."""
    if device is None:
        return default_device()
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d
