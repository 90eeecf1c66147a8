"""Deprecated alias: `ServeEngine` → `ServeSession` (DESIGN.md §17).

The sequential serving engine merged into the unified `ServeSession`
submission surface; this shim keeps the old constructor and ``serve``
signature for one release and delegates everything to a session.
"""
from __future__ import annotations

import warnings
from typing import Optional

from ..models.api import Model
from .session import ServeSession, ServeStats

__all__ = ["ServeEngine", "ServeStats"]


class ServeEngine:
    def __init__(self, model: Model, params, max_len: int = 512,
                 prefix_repo=None):
        warnings.warn(
            "ServeEngine is deprecated; use repro_torch.serve.session.ServeSession "
            "(one submission surface for sequential and batched serving)",
            DeprecationWarning, stacklevel=2)
        kv = None
        if prefix_repo is not None:
            # accept both the old PrefixRepository shim and a bare
            # KVRepository
            kv = getattr(prefix_repo, "kv", prefix_repo)
        self._session = ServeSession(model, params, n_slots=1,
                                     max_len=max_len, kv=kv)
        self.model = model
        self.params = params
        self.max_len = max_len
        self.repo = prefix_repo

    def serve(self, prompt, n_decode: int) -> tuple:
        return self._session.serve(prompt, n_decode)
