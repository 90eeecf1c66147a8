"""Uniform model API of the port: ``build(config) -> Model`` with
init / prefill / decode / loss entry points (``src/repro/models/api.py``).

The reference's ``input_specs`` and ``init_shapes`` belong to its
dry-run and come with ``launch/dryrun.py``.  Every architecture of the
registry builds; the encoder-decoder family (seamless-m4t-medium) takes
its own batch keys, as in the reference: ``enc_embeds`` and
``enc_positions`` beside the decoder's ``tokens`` and ``positions``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from ..device import resolve
from . import encdec as ED
from . import lm as LM
from .config import ModelConfig


@dataclasses.dataclass
class Model:
    cfg: ModelConfig
    device: torch.device

    @property
    def _encdec(self) -> bool:
        return self.cfg.family == "encdec"

    # ------------------------------------------------------------------ init
    def init(self, seed: int = 0) -> Dict:
        """Random parameters from a ``torch.Generator`` seeded with
        ``seed``, made on the model's device."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        if self._encdec:
            return ED.init_encdec(self.cfg, gen)
        return LM.init_lm(self.cfg, gen)

    # ---------------------------------------------------------------- fwd/loss
    def loss_fn(self, params, batch):
        """Mean next-token cross-entropy plus 0.01 times the MoE's
        load-balancing loss: (total, (loss, aux)).  Differentiable:
        ``total.backward()`` reaches every leaf of ``params`` that
        requires a gradient, attention's through the backward kernel on
        the card (``kernels/flash_attention``; MLA's unequal head dims in
        bf16), the recurrent mixers' plain loops (``models/ssm.py``) by
        autograd, with superblocks (encoder and decoder layers)
        recomputed under ``cfg.remat``."""
        cfg = self.cfg
        if self._encdec:
            logits, aux = ED.encdec_forward(
                cfg, params, batch["enc_embeds"], batch["tokens"],
                batch["enc_positions"], batch["positions"])
            return LM.loss_from_logits(logits, aux, batch["labels"])
        return LM.lm_loss(cfg, params, _inputs(batch), batch["positions"],
                          batch["labels"])

    # ---------------------------------------------------------------- serving
    def init_cache(self, batch: int, max_len: int, enc_len: int = 0):
        """Zeroed decode caches; an encoder-decoder model's cross-attention
        leaves hold ``enc_len`` positions (default ``max_len``)."""
        if self._encdec:
            return ED.init_dec_cache(self.cfg, batch, max_len,
                                     enc_len or max_len, self.device)
        return LM.init_cache(self.cfg, batch, max_len, self.device)

    def prefill(self, params, batch, cache, start=None):
        """Writes into ``cache``; returns (last-token logits, cache).  An
        encoder-decoder model encodes ``enc_embeds`` and prefills from
        position 0 (``start`` is ignored, as in the reference); its
        returned cache holds the cross K and V it computed."""
        cfg = self.cfg
        if self._encdec:
            return ED.encdec_prefill(cfg, params, batch["enc_embeds"],
                                     batch["enc_positions"], batch["tokens"],
                                     batch["positions"], cache)
        return LM.lm_prefill(cfg, params, _inputs(batch), batch["positions"],
                             cache, start)

    def decode_step(self, params, batch, cache, index):
        """Writes into ``cache``; returns (logits, cache)."""
        cfg = self.cfg
        if self._encdec:
            return ED.encdec_decode(cfg, params, batch["tokens"],
                                    batch["positions"], cache, index)
        return LM.lm_decode(cfg, params, _inputs(batch), batch["positions"],
                            cache, index)

    # ---------------------------------------------------------------- demo data
    def demo_batch(self, seed: int, seq: int, gbs: int):
        """Small concrete batch for smoke tests, on the model's device:
        labels, positions ((3, B, S) for M-RoPE), and token ids or, with
        the embeddings frontend, (B, S, d) embeddings; an encoder-decoder
        model takes (B, S, d) ``enc_embeds`` with ``enc_positions`` and
        decoder token ids, whatever its frontend."""
        cfg = self.cfg
        gen = torch.Generator(device=self.device).manual_seed(seed)
        v = cfg.vocab_size
        pos = torch.arange(seq, dtype=torch.int32, device=self.device)
        if cfg.m_rope:
            pos = pos[None, None].expand(3, gbs, seq).contiguous()
        batch = {"positions": pos,
                 "labels": torch.randint(0, v, (gbs, seq), generator=gen,
                                         device=self.device)}

        def embeds():
            return torch.randn((gbs, seq, cfg.d_model), generator=gen,
                               device=self.device).to(getattr(torch,
                                                              cfg.dtype))
        if self._encdec:
            batch["enc_embeds"] = embeds()
            batch["enc_positions"] = pos.clone()
            batch["tokens"] = torch.randint(0, v, (gbs, seq), generator=gen,
                                            device=self.device)
        elif cfg.frontend == "embeds":
            batch["embeds"] = embeds()
        else:
            batch["tokens"] = torch.randint(0, v, (gbs, seq), generator=gen,
                                            device=self.device)
        return batch


def _inputs(batch):
    """A decoder-only model's input: ``embeds`` where the batch has them
    (the embeddings frontend), else ``tokens``, as the reference reads
    it."""
    return batch.get("embeds", batch.get("tokens"))


def build(cfg: ModelConfig, device=None) -> Model:
    """A model on ``device`` (default: the CUDA card)."""
    return Model(cfg, resolve(device))
