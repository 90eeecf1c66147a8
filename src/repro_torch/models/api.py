"""Uniform model API of the port: ``build(config) -> Model`` with
init / prefill / decode / loss entry points (``src/repro/models/api.py``).

The reference's ``input_specs`` and ``init_shapes`` belong to its
dry-run and come with ``launch/dryrun.py``.  A model the port cannot run
yet raises ``NotImplementedError`` in ``build``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from ..device import resolve
from . import lm as LM
from .config import ModelConfig


@dataclasses.dataclass
class Model:
    cfg: ModelConfig
    device: torch.device

    # ------------------------------------------------------------------ init
    def init(self, seed: int = 0) -> Dict:
        """Random parameters from a ``torch.Generator`` seeded with
        ``seed``, made on the model's device."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return LM.init_lm(self.cfg, gen)

    # ---------------------------------------------------------------- fwd/loss
    def loss_fn(self, params, batch):
        """Mean next-token cross-entropy plus 0.01 times the MoE's
        load-balancing loss: (total, (loss, aux)).  Differentiable:
        ``total.backward()`` reaches every leaf of ``params`` that
        requires a gradient, attention's through the backward kernel on
        the card (``kernels/flash_attention``, which does not take MLA's
        unequal head dims yet), the recurrent mixers' plain loops
        (``models/ssm.py``) by autograd, with superblocks recomputed
        under ``cfg.remat``."""
        return LM.lm_loss(self.cfg, params, _inputs(batch),
                          batch["positions"], batch["labels"])

    # ---------------------------------------------------------------- serving
    def init_cache(self, batch: int, max_len: int):
        return LM.init_cache(self.cfg, batch, max_len, self.device)

    def prefill(self, params, batch, cache, start=None):
        """Writes into ``cache``; returns (last-token logits, cache)."""
        return LM.lm_prefill(self.cfg, params, _inputs(batch),
                             batch["positions"], cache, start)

    def decode_step(self, params, batch, cache, index):
        """Writes into ``cache``; returns (logits, cache)."""
        return LM.lm_decode(self.cfg, params, _inputs(batch),
                            batch["positions"], cache, index)

    # ---------------------------------------------------------------- demo data
    def demo_batch(self, seed: int, seq: int, gbs: int):
        """Small concrete batch for smoke tests, on the model's device:
        labels, positions ((3, B, S) for M-RoPE), and token ids or, with
        the embeddings frontend, (B, S, d) embeddings."""
        cfg = self.cfg
        gen = torch.Generator(device=self.device).manual_seed(seed)
        v = cfg.vocab_size
        pos = torch.arange(seq, dtype=torch.int32, device=self.device)
        if cfg.m_rope:
            pos = pos[None, None].expand(3, gbs, seq).contiguous()
        batch = {"positions": pos,
                 "labels": torch.randint(0, v, (gbs, seq), generator=gen,
                                         device=self.device)}
        if cfg.frontend == "embeds":
            batch["embeds"] = torch.randn(
                (gbs, seq, cfg.d_model), generator=gen,
                device=self.device).to(getattr(torch, cfg.dtype))
        else:
            batch["tokens"] = torch.randint(0, v, (gbs, seq), generator=gen,
                                            device=self.device)
        return batch


def _inputs(batch):
    """The model's input: ``embeds`` where the batch has them (the
    embeddings frontend), else ``tokens``, as the reference reads it."""
    return batch.get("embeds", batch.get("tokens"))


def build(cfg: ModelConfig, device=None) -> Model:
    """A model on ``device`` (default: the CUDA card).  Raises
    NotImplementedError for a family the port does not run yet."""
    LM.check_ported(cfg)
    return Model(cfg, resolve(device))
