"""Requests to a served model through ``ServeSession`` with a
``KVRepository`` over a ``KVTierStore``.

The port serves an MLA model (minicpm3-4b) one request at a time
through ``ServeSession.serve``: its latent cache is written at one index
for every row, so the batched ``submit``/``step`` path raises for it.
So one client sends its requests back to back (a closed loop with no
think time), and a request's time to first token runs from its start.

Request sizes and the order of documents come from the traffic file's
``schedule_seed``, so every run seed gets the same work; token ids come
from the run seed.  Once the window has closed a sample
of finished requests, with the longest among them, is run through the
float32 reference (``reference/minicpm3_ref.py``), and each served
token's reference logit is held against the reference's best."""
from __future__ import annotations

import math
import time
from typing import Dict, List

import numpy as np
import torch

from ..reference import minicpm3_ref
from ..yardstick import mla_weights


def _loguniform(rng, lo, hi, n):
    return np.exp(rng.uniform(math.log(lo), math.log(hi), n)).round() \
        .astype(np.int64)


def schedule(tr: Dict, n: int) -> List[Dict]:
    """The first ``n`` requests (sizes, document ids) and the set-up
    requests, from the file's schedule seed.  ``doc`` requests
    draw a document from a live pool; each document is asked a drawn
    number of times and is then replaced by a fresh one."""
    rng = np.random.default_rng(tr["schedule_seed"])
    ans = rng.integers(tr["answer_tokens"][0], tr["answer_tokens"][1] + 1, n)
    reqs, setup = [], []
    if tr["kind"] == "fresh":
        plen = _loguniform(rng, *tr["prompt_tokens"], n)
        for i in range(n):
            reqs.append(dict(doc=None, doc_len=0, q_len=int(plen[i]),
                             answer=int(ans[i])))
        setup.append(dict(doc=None, doc_len=0, q_len=int(plen[0]), answer=2))
        return reqs, setup
    lo, hi = tr["doc_tokens"]
    a_lo, a_hi = tr["asks_per_doc"]
    docs_len = _loguniform(rng, lo, hi, n + tr["live_docs"])
    asks = rng.integers(a_lo, a_hi + 1, n + tr["live_docs"])
    qlen = rng.integers(tr["question_tokens"][0],
                        tr["question_tokens"][1] + 1, n + tr["live_docs"])
    live = list(range(tr["live_docs"]))
    # a pool already running: each live document has had 1..asks-1 asks
    left = {d: int(rng.integers(1, asks[d])) for d in live}
    nxt = tr["live_docs"]
    for d in live:
        # prefill only, but the first also decodes: every shape warm
        setup.append(dict(doc=d, doc_len=int(docs_len[d]),
                          q_len=int(qlen[n + d]), answer=2 if d == 0 else 0))
    for i in range(n):
        slot = int(rng.integers(len(live)))
        d = live[slot]
        reqs.append(dict(doc=d, doc_len=int(docs_len[d]), q_len=int(qlen[i]),
                         answer=int(ans[i])))
        left[d] -= 1
        if left[d] <= 0:
            live[slot] = nxt
            left[nxt] = int(asks[nxt])
            nxt += 1
    return reqs, setup


class Driver:
    kind = "requests"

    def __init__(self, config: Dict, traffic: Dict, seed: int, device, rec):
        self.cfg, self.tr, self.seed = config, traffic, int(seed)
        self.device, self.rec = torch.device(device), rec
        self.events: List[Dict] = []
        self.failed = 0

    # ------------------------------------------------------------ tokens
    def _tokens(self, req: Dict) -> np.ndarray:
        """A request's prompt: its document's tokens (the same for every
        ask of the document), then its own question, from the run
        seed."""
        v = self.cfg["vocab_size"]
        parts = []
        if req["doc"] is not None:
            g = np.random.default_rng([self.seed % (1 << 63), 1, req["doc"]])
            parts.append(g.integers(0, v, req["doc_len"]))
        g = np.random.default_rng([self.seed % (1 << 63), 2, self._qid])
        self._qid += 1
        parts.append(g.integers(0, v, req["q_len"]))
        return np.concatenate(parts).astype(np.int32)

    # ------------------------------------------------------------ set-up
    def program_config(self):
        """The program's ModelConfig with every size of the config file
        (the port's own file gives the layout; the numbers are the
        file's)."""
        from repro_torch.models.config import MLAConfig, ModelConfig
        c = self.cfg
        mla = MLAConfig(q_lora_rank=c["q_lora_rank"],
                        kv_lora_rank=c["kv_lora_rank"],
                        qk_nope_head_dim=c["qk_nope_head_dim"],
                        qk_rope_head_dim=c["qk_rope_head_dim"],
                        v_head_dim=c["v_head_dim"])
        return ModelConfig(
            name=c["name"], family="dense", n_layers=c["num_hidden_layers"],
            d_model=c["hidden_size"], n_heads=c["num_attention_heads"],
            n_kv_heads=c["num_key_value_heads"],
            head_dim=c["qk_nope_head_dim"], d_ff=c["intermediate_size"],
            vocab_size=c["vocab_size"], mla=mla, rope_theta=c["rope_theta"],
            norm_eps=c["rms_norm_eps"], tie_embeddings=False,
            dtype=c["torch_dtype"], remat=False)

    def setup(self):
        from repro_torch.models.api import build
        from repro_torch.serve.kv_repo import KVRepository
        from repro_torch.serve.kv_store import KVTierStore
        from repro_torch.serve.session import ServeSession

        c, tr = self.cfg, self.tr
        self.weights = mla_weights.make(c, self.seed, self.device,
                                        getattr(torch, c["torch_dtype"]))
        self.model = build(self.program_config(), device=self.device)
        kv = KVRepository(budget_bytes=c["kv_budget_bytes"],
                          store=KVTierStore(host_bytes=c["kv_host_bytes"]))
        self.session = ServeSession(self.model, self.weights, n_slots=1,
                                    max_len=tr["max_len"], kv=kv)
        self.reqs, setup = schedule(tr, tr["max_requests"])
        self._qid = 0
        self._hook()
        with torch.no_grad():
            for r in setup:
                self.session.serve(self._tokens(r), r["answer"])
        self._install_spans()
        torch.cuda.synchronize(self.device) \
            if self.device.type == "cuda" else None

    def _hook(self):
        """Every token the session emits is known when its next decode
        step is called (the first one from the prefill's logits): the
        time of each call is a token's time."""
        self._marks: List[float] = []
        inner = self.session._decode

        def decode(batch, cache, index):
            self._marks.append(time.perf_counter())
            return inner(batch, cache, index)
        self.session._decode = decode

    def _install_spans(self):
        rec = self.rec
        if not rec.traced:
            return
        from repro_torch.kernels.flash_attention import ops as fa
        s = self.session

        def count(params, batch, cache, start=None):
            rec.counters["prefill_tokens"] += int(batch["tokens"].shape[1])
            rec.counters["prefill_calls"] += 1
        rec.wrap(self.model, "prefill", "model.prefill", sync=True,
                 on_call=count)
        rec.wrap(self.model, "decode_step", "model.decode_step", sync=True)
        rec.wrap(s.kv, "splice", "kv.splice", sync=True)
        rec.wrap(s.kv, "store_prefix", "kv.store_prefix", sync=True)
        rec.wrap(s.kv, "probe", "kv.probe")

        def attn(q, k, v, kv_len=None, *, causal=True, q_offset=None):
            b, hq, sq, d = q.shape
            skv = k.shape[2]
            kvl = skv if kv_len is None else kv_len
            qo = skv - sq if q_offset is None else q_offset
            kvl = int(kvl) if not torch.is_tensor(kvl) else int(kvl.max())
            qo = int(qo) if not torch.is_tensor(qo) else int(qo.max())
            rec.calls["flash_attention"].append(
                (b, hq, k.shape[1], sq, d, v.shape[3], kvl, qo, bool(causal),
                 q.element_size()))
        rec.wrap(fa, "mha", "kernel.flash_attention", on_call=attn)

    # ------------------------------------------------------------ window
    def window(self, seconds: float):
        s = self.session
        st0 = dict(s.stats)
        self._marks.clear()
        self.t0 = time.perf_counter()
        self.t0_ns = time.time_ns()
        self.t_end = self.t0 + seconds
        self.kept = []
        for i, r in enumerate(self.reqs):
            if time.perf_counter() >= self.t_end:
                break
            prompt = self._tokens(r)
            m0 = len(self._marks)
            t_start = time.perf_counter()
            try:
                with self.rec.span("serve.request"):
                    with torch.no_grad():
                        out, stats = s.serve(prompt, r["answer"])
            except Exception as e:
                self.failed += 1
                self.events.append(dict(i=i, start=t_start, error=repr(e)))
                continue
            t_done = time.perf_counter()
            marks = self._marks[m0:]
            self.events.append(dict(
                i=i, start=t_start, done=t_done,
                first=marks[0] if marks else t_done, marks=marks,
                prompt_len=len(prompt), out_len=len(out),
                reused=int(stats.reused_tokens),
                prefilled=int(stats.prefilled_tokens)))
            self.kept.append((prompt, np.asarray(out)))
        else:
            raise RuntimeError("the traffic file's max_requests ran out "
                               "inside the window")
        self.t_close = time.perf_counter()
        self.t_close_ns = time.time_ns()
        self.stats0, self.stats1 = st0, dict(s.stats)

    def drain(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def release(self):
        self.rec.unwrap()
        del self.session, self.model
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------ verdict
    def _sample(self):
        """The requests judged: the longest finished one, then others
        drawn from the run seed, up to ``check_requests``."""
        kept = self.kept
        if not kept:
            return []
        longest = max(range(len(kept)), key=lambda i: len(kept[i][0]))
        rest = [i for i in range(len(kept)) if i != longest]
        rng = np.random.default_rng([self.seed % (1 << 63), 3])
        rng.shuffle(rest)
        pick = [longest] + rest[:self.tr["check_requests"] - 1]
        return [kept[i] for i in sorted(pick)]

    def _ref_logits(self, sample, quantize=False):
        seqs, rows = [], []
        for prompt, out in sample:
            toks = np.concatenate([prompt, out[:-1]]).astype(np.int64)
            seqs.append(torch.as_tensor(toks, device=self.device))
            rows.append(torch.arange(len(prompt) - 1,
                                     len(prompt) - 1 + len(out),
                                     device=self.device))
        return minicpm3_ref.logits(self.cfg, self.weights, seqs, rows,
                                   quantize=quantize)

    def verify(self) -> Dict[str, float]:
        """``logit_gap``: the widest gap by which a served token's
        reference logit lies below the reference's best at its
        position."""
        sample = self._sample()
        gap = 0.0
        n_tok = 0
        for (prompt, out), lg in zip(sample, self._ref_logits(sample)):
            served = torch.as_tensor(out.astype(np.int64), device=lg.device)
            g = lg.max(-1).values - lg.gather(1, served[:, None])[:, 0]
            gap = max(gap, float(g.max()))
            n_tok += len(out)
        return {"logit_gap": gap, "checked": float(len(sample)),
                "tokens": float(n_tok)}

    def control(self) -> Dict[str, float]:
        """The reference with float8 weights in the program's place: at
        each judged position, the gap of the token it puts first."""
        sample = self._sample()
        ref = self._ref_logits(sample)
        low = self._ref_logits(sample, quantize=True)
        gap = 0.0
        for a, b in zip(ref, low):
            pick = b.argmax(-1)
            g = a.max(-1).values - a.gather(1, pick[:, None])[:, 0]
            gap = max(gap, float(g.max()))
        return {"logit_gap": gap}

    # ---------------------------------------------------------- records
    def notes(self) -> Dict[str, float]:
        ok = [e for e in self.events if "done" in e]
        kv = {k: self.stats1[k] - self.stats0.get(k, 0) for k in
              ("reused_tokens", "prefilled_tokens")}
        return dict(requests=len(ok),
                    cold=sum(1 for e in ok if e["reused"] == 0), **kv)

    def record(self) -> Dict:
        ok = [e for e in self.events if "done" in e]
        return dict(kind=self.kind, t0=self.t0, t_end=self.t_end,
                    t0_ns=self.t0_ns, t_close_ns=self.t_close_ns,
                    window_s=self.t_end - self.t0, events=ok,
                    attempted=len(self.events), failed=self.failed,
                    marks=list(self._marks), stats0=self.stats0,
                    stats1=self.stats1)
