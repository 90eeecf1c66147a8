"""Deprecated alias: `BatchEngine` → `ServeSession` (DESIGN.md §17).

Continuous batching lives in the unified `ServeSession`; this shim keeps
the old ``submit(prompt, max_new, rid)`` / ``step`` / ``run`` surface
for one release.  `Request` is the old name for `ServeRequest` (the
first three fields are positionally identical).
"""
from __future__ import annotations

import warnings
from typing import Optional

from ..models.api import Model
from .session import ServeRequest as Request
from .session import ServeSession

__all__ = ["BatchEngine", "Request"]


class BatchEngine:
    def __init__(self, model: Model, params, n_slots: int = 4,
                 max_len: int = 256, prefix_repo=None,
                 eos_token: int = -1):
        warnings.warn(
            "BatchEngine is deprecated; use repro_torch.serve.session.ServeSession "
            "(one submission surface for sequential and batched serving)",
            DeprecationWarning, stacklevel=2)
        kv = None
        if prefix_repo is not None:
            kv = getattr(prefix_repo, "kv", prefix_repo)
        self._session = ServeSession(model, params, n_slots=n_slots,
                                     max_len=max_len, kv=kv,
                                     eos_token=eos_token, every_k=0)
        self.model = model
        self.params = params
        self.repo = prefix_repo

    # old surface: submit returns the request object itself
    def submit(self, prompt, max_new: int, rid: int) -> Request:
        t = self._session.submit(prompt, max_new)
        t.request.rid = rid
        return t.request

    def step(self) -> bool:
        return self._session.step()

    def run(self, max_steps: int = 10_000) -> None:
        self._session.run(max_steps)

    @property
    def queue(self):
        return [r for q in self._session._queues.values() for r in q]

    @property
    def slot_req(self):
        return self._session.slot_req
