"""Uniform model API of the port: ``build(config) -> Model`` with
init / prefill / decode / loss entry points and, for the dry-run
(``launch/dryrun.py``), the assigned input shapes with ``init_shapes``
and ``input_specs`` (``src/repro/models/api.py``).  Tensors on the
``meta`` device stand in for ``jax.ShapeDtypeStruct``: shapes and dtypes,
no storage.  Every architecture of the registry builds; the
encoder-decoder family (seamless-m4t-medium) takes its own batch keys,
as in the reference: ``enc_embeds`` and ``enc_positions`` beside the
decoder's ``tokens`` and ``positions``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import _disable_current_modes

from .. import trace
from ..device import resolve
from ..tree import tree_leaves
from . import dist
from . import encdec as ED
from . import layers as L
from . import lm as LM
from .config import ModelConfig
from .layers import MetaGenerator, _dtype

META = torch.device("meta")

# assigned input shapes: name -> (seq_len, global_batch, kind)
SHAPES = {
    "train_4k": (4_096, 256, "train"),
    "prefill_32k": (32_768, 32, "prefill"),
    "decode_32k": (32_768, 128, "decode"),
    "long_500k": (524_288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: str) -> Tuple[bool, str]:
    if shape == "long_500k" and not cfg.is_subquadratic():
        return False, ("pure full-attention architecture: long_500k needs "
                       "sub-quadratic attention (skip noted in DESIGN.md)")
    return True, ""


class _DecodeGraph:
    """One-token decode step of an MLA stack (``LM.mla_stack``) as CUDA
    graphs broken at each layer's attention: the first graph runs from
    the embedding to layer 0's latent write, each next one from a
    layer's attention output to the next layer's latent write, the last
    on to the logits.  Between two graphs the host runs the layer's
    latent decompression and attention eagerly at the step's int index
    (``L.split_attention``) and copies the output into the buffer the
    next graph reads, so the attention kernel is launched from Python at
    every step, as in an eager one.  The graphs' inputs are static
    buffers (tokens, positions, the 0-d latent index) that each replay
    is fed; their output is the static logits.  It holds the parameters
    and the cache it was captured on, whose memory the graphs read and
    write."""

    def __init__(self, cfg: ModelConfig, key, params, batch, cache,
                 index: int):
        dev = batch["tokens"].device
        self.key, self.params, self.cache = key, params, cache
        self.tokens = batch["tokens"].clone()
        self.positions = batch["positions"].clone()
        self.index = torch.full((), index, dtype=torch.int32, device=dev)
        self.graphs, self.attends = [], []
        main = torch.cuda.current_stream(dev)

        def step():
            return LM.lm_decode(cfg, params, self.tokens, self.positions,
                                cache, self.index)[0]

        def split(attend, shape, dtype):
            self.graphs[-1].capture_end()
            with torch.cuda.stream(main):
                out = torch.empty(shape, dtype=dtype, device=dev)
            self.attends.append((attend, out))
            self._begin(pool)
            return out

        with torch.cuda.device(dev):
            side = torch.cuda.Stream(dev)
            side.wait_stream(main)
            with torch.cuda.stream(side):
                # the warm-up, eager and split as a replay is: this
                # call's step, with kernels loaded and lazy set-up done
                # before the capture
                with L.split_attention(lambda attend, *_: attend(index)):
                    self.first = step()
                torch.cuda.synchronize(dev)
                pool = torch.cuda.graph_pool_handle()
                self._begin(pool)
                try:
                    with L.split_attention(split):
                        self.logits = step()
                finally:
                    self.graphs[-1].capture_end()
            main.wait_stream(side)
        self.first.record_stream(main)

    def _begin(self, pool) -> None:
        g = torch.cuda.CUDAGraph()
        g.capture_begin(pool=pool, capture_error_mode="thread_local")
        self.graphs.append(g)

    def replay(self, batch, index: int):
        """The step at ``index``; returns a copy of the logits."""
        self.tokens.copy_(batch["tokens"])
        self.positions.copy_(batch["positions"])
        self.index.fill_(index)
        for graph, (attend, out) in zip(self.graphs, self.attends):
            graph.replay()
            out.copy_(attend(index))
        self.graphs[-1].replay()
        return self.logits.clone()


@dataclasses.dataclass
class Model:
    cfg: ModelConfig
    device: torch.device
    # the captured decode step, at most one (``decode_step``)
    _graph: Optional[_DecodeGraph] = dataclasses.field(
        default=None, init=False, repr=False, compare=False)

    @property
    def _encdec(self) -> bool:
        return self.cfg.family == "encdec"

    # ------------------------------------------------------------------ init
    def init(self, seed: int = 0) -> Dict:
        """Random parameters from a ``torch.Generator`` seeded with
        ``seed``, made on the model's device (on ``meta``: shapes and
        dtypes only)."""
        gen = MetaGenerator() if self.device == META \
            else torch.Generator(device=self.device)
        gen.manual_seed(seed)
        if self._encdec:
            return ED.init_encdec(self.cfg, gen)
        return LM.init_lm(self.cfg, gen)

    def init_shapes(self, seed: int = 0) -> Dict:
        """The parameter tree as ``meta`` tensors: the reference's
        ``jax.eval_shape`` of ``init``.  Made outside any dispatch mode:
        shapes are no work of a step, so a sharded step that reads its
        layout from them allocates nothing a dry-run's ``CostMode``
        would count."""
        with _disable_current_modes():
            return dataclasses.replace(self, device=META).init(seed)

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
        leaves hold ``enc_len`` positions (default ``max_len``).  Over the
        ranks of a ``GroupMesh`` under ``dist.optimized()`` a rank's
        layout, leaf by leaf: GQA K and V its S-slice, every other leaf
        whole (``models/lm.py::init_cache``)."""
        if self._encdec:
            return ED.init_dec_cache(self.cfg, batch, max_len,
                                     enc_len or max_len, self.device)
        return LM.init_cache(self.cfg, batch, max_len, self.device)

    def prefill(self, params, batch, cache, start=None):
        """Writes into ``cache``; returns (last-token logits, cache).  An
        encoder-decoder model encodes ``enc_embeds`` and prefills from
        position 0 (``start`` is ignored, as in the reference); its
        returned cache holds the cross K and V it computed.  The spans
        ``lm.prefill`` here and ``lm.decode`` in ``decode_step`` run from
        entry to return, unsynchronised: the host's time to issue the
        call's work."""
        cfg = self.cfg
        with trace.span("lm.prefill"):
            if self._encdec:
                return ED.encdec_prefill(
                    cfg, params, batch["enc_embeds"], batch["enc_positions"],
                    batch["tokens"], batch["positions"], cache)
            return LM.lm_prefill(cfg, params, _inputs(batch),
                                 batch["positions"], cache, start)

    def decode_step(self, params, batch, cache, index):
        """Writes into ``cache``; returns (logits, cache).

        Where the step can be captured (``_graph_key``: an MLA stack
        decoding one token at an int index on the card, gradients off,
        no mesh), it replays CUDA graphs of the step, broken at each
        layer's attention, which runs eagerly between them
        (``_DecodeGraph``).  The graphs are captured at the first call
        for their key (parameters, cache leaves, input shapes), which
        replaces the model's older graphs; each later call copies its
        tokens, positions and index into the graphs' static buffers and
        replays them: the host issues a launch a layer, and the
        attention's, where it issued every operation's.  The returned
        logits are the caller's to keep.  Every other call runs eagerly.
        The span ``lm.decode`` covers the replay; the counters
        ``lm.decode_graph.captures`` and ``lm.decode_graph.replays``
        count the two kinds of graphed call."""
        cfg = self.cfg
        with trace.span("lm.decode"):
            if self._encdec:
                return ED.encdec_decode(cfg, params, batch["tokens"],
                                        batch["positions"], cache, index)
            key = self._graph_key(params, batch, cache, index)
            if key is None:
                return LM.lm_decode(cfg, params, _inputs(batch),
                                    batch["positions"], cache, index)
            g = self._graph
            if g is not None and g.key == key:
                logits = g.replay(batch, int(index))
                trace.count("lm.decode_graph.replays")
            else:
                self._graph = None      # the older graphs' pool first
                g = self._graph = _DecodeGraph(cfg, key, params, batch,
                                               cache, int(index))
                logits, g.first = g.first, None
                trace.count("lm.decode_graph.captures")
            return logits, cache

    def release_graph(self, cache) -> None:
        """Frees the captured decode step if it was captured on
        ``cache`` (a ``ServeSession``'s request cache, when the session
        goes)."""
        if self._graph is not None and self._graph.cache is cache:
            self._graph = None

    def _graph_key(self, params, batch, cache, index):
        """What a captured decode step is bound to, or None where the
        step cannot be captured: tensors off the card (the CPU, the
        dry-run's ``meta``), gradients on, a mesh set (the sharded
        paths), a stack other than MLA and MLP sublayers
        (``LM.mla_stack``), embeddings for input, more than one new
        token, or an index that is a tensor (the eager attention between
        the graphs takes it from the host)."""
        tokens = batch.get("tokens")
        if (self.device.type != "cuda" or torch.is_grad_enabled()
                or dist.get_mesh() is not None or "embeds" in batch
                or tokens is None or tokens.shape[-1] != 1
                or isinstance(index, torch.Tensor)
                or not LM.mla_stack(self.cfg)):
            return None
        leaves = tree_leaves((params, cache))
        if not all(t.is_cuda for t in leaves):
            return None
        pos = batch["positions"]
        return (tuple((t.data_ptr(), t.shape) for t in leaves),
                tokens.shape, tokens.dtype, pos.shape, pos.dtype)

    # ---------------------------------------------------------------- specs
    def input_specs(self, shape_name: str) -> Dict:
        """``meta`` stand-ins for every model input of an assigned shape
        (no storage): the reference's dry-run contract.  train: the
        batch; prefill: the batch and a cache of ``seq`` positions;
        decode: one new token, a cache of ``seq`` positions and the
        0-d int32 index."""
        seq, gbs, kind = SHAPES[shape_name]
        return self.specs(kind, seq, gbs)

    def specs(self, kind: str, seq: int, batch: int, enc_seq: int = None):
        """``input_specs`` at any (kind, seq, batch); an encoder-decoder
        model's encoder at ``enc_seq`` frames (default: ``seq``, and at
        most 32768 for decode's cross cache, as the reference's)."""
        cfg = self.cfg
        meta = dataclasses.replace(self, device=META)
        dt = _dtype(cfg)

        def spec(shape, dtype=torch.int32):
            return torch.empty(shape, dtype=dtype, device=META)

        s = 1 if kind == "decode" else seq
        b = {"positions": spec((3, batch, s) if cfg.m_rope else (s,))}
        if self._encdec:
            if kind != "decode":
                b["enc_embeds"] = spec((batch, enc_seq or seq, cfg.d_model),
                                       dt)
                b["enc_positions"] = spec((enc_seq or seq,))
            b["tokens"] = spec((batch, s))
        elif cfg.frontend == "embeds":
            b["embeds"] = spec((batch, s, cfg.d_model), dt)
        else:
            b["tokens"] = spec((batch, s))
        if kind == "train":
            b["labels"] = spec((batch, seq))
            return b
        if kind == "prefill":
            return {"batch": b, "cache": meta.init_cache(
                batch, seq, enc_len=enc_seq or seq)}
        # decode: one new token against a cache of length seq
        return {"batch": b,
                "cache": meta.init_cache(batch, seq,
                                         enc_len=enc_seq or min(seq, 32768)),
                "index": spec(())}

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
