"""One submission surface for serving (DESIGN.md §17), the port of
``src/repro/serve/session.py``, run eagerly (no jit; capturing the
decode step in a CUDA graph is later work).

`ServeSession` merges the sequential `ServeEngine` and the
continuous-batching `BatchEngine` behind one API, shaped like the
analytics `ReStoreService`: requests are objects with tenant / deadline
semantics, ``submit`` returns a ticket, identical in-flight prompts are
singleflighted (followers share the leader's decode), queue admission is
round-robin across tenants, and a bounded queue applies backpressure.

Prefix reuse flows through the `KVRepository` verbs — ``probe`` (pure
longest-prefix lookup), ``splice`` (materialize the snapshot from the
tier store; a quarantined blob degrades to a cold prefill), and
``record_use`` (credit the hit) — with the spliced entry pinned for the
duration of the decode, exactly as the analytics driver pins workflow
artifacts while downstream jobs consume them.

The reused state is the same numbers the prefill would have produced
(the fingerprint chain guarantees the tokens match), so reuse only
removes redundant compute — the ReStore contract.  On the CPU greedy
decodes are bit-identical with or without reuse.  On the card the
attention kernel is batch-invariant, but the suffix prefill's matrix
products run at another M than a cold prefill's, so logits may differ
in their last bits.

The model writes its cache in place, and the KV store's snapshots are
immutable: a spliced snapshot is copied before a prefill or decode
writes into it.
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..models.api import Model
from ..tree import tree_map
from .kv_repo import KVRepository


class SessionSaturated(RuntimeError):
    """Backpressure: the session queue is full — retry later."""


@dataclasses.dataclass
class ServeStats:
    prefilled_tokens: int
    reused_tokens: int
    decoded_tokens: int
    wall_s: float


@dataclasses.dataclass
class ServeRequest:
    """One serving request.  ``rid``/``prompt``/``max_new`` keep the old
    `batch_engine.Request` positional layout; tenant/deadline/ticket
    semantics are the §17 unification with the service submission API."""
    rid: int
    prompt: np.ndarray
    max_new: int
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    tenant: str = "default"
    # admission deadline in session steps (logical time, deterministic):
    # a request still queued after this many ``step()`` calls expires
    deadline_steps: Optional[int] = None
    error: Optional[str] = None
    stats: Optional[ServeStats] = None
    submitted_at: int = 0
    followers: List["ServeRequest"] = dataclasses.field(
        default_factory=list)


class ServeTicket:
    """Handle returned by ``submit``: resolved when the session's run
    loop finishes (or expires) the request."""

    def __init__(self, request: ServeRequest):
        self.request = request

    def done(self) -> bool:
        return self.request.done

    def result(self) -> np.ndarray:
        if not self.request.done:
            raise RuntimeError(
                "request not finished — drive ServeSession.run()/step()")
        if self.request.error is not None:
            raise RuntimeError(self.request.error)
        return np.asarray(self.request.out, np.int32)


class ServeSession:
    def __init__(self, model: Model, params, *, n_slots: int = 4,
                 max_len: int = 256, kv: Optional[KVRepository] = None,
                 eos_token: int = -1, every_k: int = 8,
                 max_queue: int = 256):
        self.model = model
        self.params = params
        self.n_slots = n_slots
        self.max_len = max_len
        self.kv = kv
        self.eos = eos_token
        self.every_k = every_k
        self.max_queue = max_queue

        self.cache = model.init_cache(n_slots, max_len)
        self.slot_req: List[Optional[ServeRequest]] = [None] * n_slots
        self.slot_pos = np.zeros(n_slots, np.int32)   # next write index
        self.next_tok = np.zeros(n_slots, np.int32)
        self._slot_pin: List[Optional[object]] = [None] * n_slots
        self._queues: Dict[str, collections.deque] = {}
        self._tenants: List[str] = []         # round-robin order
        self._rr = 0
        self._inflight: Dict[bytes, ServeRequest] = {}
        self._rids = itertools.count()
        self._tick = 0                        # logical step counter
        self.stats = {"submitted": 0, "served": 0, "expired": 0,
                      "singleflight_hits": 0, "dup_executions": 0,
                      "reused_tokens": 0, "prefilled_tokens": 0}

    # ---------------------------------------------------------------- util
    @property
    def _positional(self) -> bool:
        cfg = self.model.cfg
        return (cfg.family in ("dense", "moe", "vlm", "encdec")
                and cfg.ssm is None and cfg.xlstm is None)

    @property
    def _device(self) -> torch.device:
        return self.model.device

    def _positions(self, start, length):
        return torch.arange(start, start + length, dtype=torch.int32,
                            device=self._device)

    def _tokens(self, toks) -> torch.Tensor:
        return torch.as_tensor(np.asarray(toks, np.int64),
                               device=self._device)

    def _decode(self, batch, cache, index):
        return self.model.decode_step(self.params, batch, cache, index)

    def _probe_splice(self, prompt: np.ndarray, *, strict: bool):
        """probe → splice, pin on success.  ``strict`` drops exact
        full-prompt hits (the batch path seeds its first token from the
        prefill logits, so it always prefills at least one token)."""
        if self.kv is None:
            return None
        hit = self.kv.probe(prompt)
        if hit is None or hit.length > len(prompt) \
                or (strict and hit.length >= len(prompt)):
            return None
        hit = self.kv.splice(hit)
        if hit is None:
            return None                # quarantined → cold prefill
        self.kv.record_use(hit)
        self.kv.pin(hit.entry)
        # the snapshot is the store's: prefill and decode write into a copy
        hit.cache = tree_map(torch.clone, hit.cache)
        return hit

    def _prefill(self, prompt, cache, start):
        """Prefill ``prompt[start:]``; feeds the cost model's online
        prefill-rate calibration (the serve-path analog of IO bandwidth
        calibration — what prices snapshots for admission)."""
        s = len(prompt)
        batch = {"tokens": self._tokens(prompt[None, start:]),
                 "positions": self._positions(start, s - start)}
        t0 = time.perf_counter()
        logits, cache = self.model.prefill(self.params, batch, cache,
                                           start=start)
        if self.kv is not None:
            if logits.is_cuda:
                torch.cuda.synchronize(logits.device)
            self.kv.cost_model.observe_prefill(
                s - start, time.perf_counter() - t0)
        return logits, cache

    # ---------------------------------------------------------- sequential
    def serve(self, prompt: np.ndarray, n_decode: int) -> tuple:
        """Synchronous single-request path: greedily decode ``n_decode``
        tokens.  Returns ``(generated tokens, ServeStats)``."""
        t0 = time.time()
        prompt = np.asarray(prompt, np.int32)
        s = len(prompt)

        reused = 0
        cache = self.model.init_cache(1, self.max_len)
        start = 0
        hit = self._probe_splice(prompt, strict=False)
        if hit is not None:
            cache = hit.cache
            start = reused = hit.length
        try:
            if start < s:
                logits, cache = self._prefill(prompt, cache, start)
            elif hit is not None and hit.logits is not None:
                # exact hit: stored logits — a recurrent state must not
                # be advanced again by replaying the final token
                logits = hit.logits
            else:
                # positional cache: replaying the last token is
                # idempotent
                batch = {"tokens": self._tokens(prompt[None, -1:]),
                         "positions": self._positions(s - 1, 1)}
                logits, cache = self._decode(batch, cache, s - 1)

            if self.kv is not None and reused < s:
                # positional (attention) caches admit intermediate-
                # prefix aliases (the sub-job enumeration analogue);
                # recurrent states are exact-length only
                self.kv.store_prefix(
                    prompt, cache, logits=logits,
                    every_k=self.every_k if self._positional else 0)

            out = []
            tok = int(torch.argmax(logits[0, -1]))
            for i in range(n_decode):
                out.append(tok)
                batch = {"tokens": self._tokens([[tok]]),
                         "positions": self._positions(s + i, 1)}
                logits, cache = self._decode(batch, cache, s + i)
                tok = int(torch.argmax(logits[0, -1]))
        finally:
            if hit is not None:
                self.kv.unpin(hit.entry)

        self.stats["served"] += 1
        self.stats["reused_tokens"] += reused
        self.stats["prefilled_tokens"] += s - reused
        return np.array(out, np.int32), ServeStats(
            prefilled_tokens=s - reused, reused_tokens=reused,
            decoded_tokens=n_decode, wall_s=time.time() - t0)

    # ---------------------------------------------------------- submission
    def submit(self, prompt: np.ndarray, max_new: int, *,
               tenant: str = "default",
               deadline_steps: Optional[int] = None) -> ServeTicket:
        """Enqueue a request; returns a ticket resolved by the run loop.
        An identical in-flight (prompt, max_new) rides the leader's
        decode (singleflight); a full queue raises `SessionSaturated`."""
        prompt = np.asarray(prompt, np.int32)
        key = prompt.tobytes() + b":" + str(int(max_new)).encode()
        leader = self._inflight.get(key)
        if leader is not None and not leader.done:
            r = ServeRequest(next(self._rids), prompt, max_new,
                             tenant=tenant, deadline_steps=deadline_steps,
                             submitted_at=self._tick)
            leader.followers.append(r)
            self.stats["singleflight_hits"] += 1
            return ServeTicket(r)
        if sum(len(q) for q in self._queues.values()) >= self.max_queue:
            raise SessionSaturated(
                f"serve queue full ({self.max_queue} requests)")
        r = ServeRequest(next(self._rids), prompt, max_new,
                         tenant=tenant, deadline_steps=deadline_steps,
                         submitted_at=self._tick)
        r._key = key
        self._inflight[key] = r
        if tenant not in self._queues:
            self._queues[tenant] = collections.deque()
            self._tenants.append(tenant)
        self._queues[tenant].append(r)
        self.stats["submitted"] += 1
        return ServeTicket(r)

    def _resolve(self, r: ServeRequest) -> None:
        r.done = True
        self._inflight.pop(getattr(r, "_key", None), None)
        for f in r.followers:
            f.out = list(r.out)
            f.error = r.error
            f.stats = r.stats
            f.done = True

    def _expire(self, r: ServeRequest) -> None:
        r.error = (f"deadline exceeded: queued {self._tick - r.submitted_at}"
                   f" steps, deadline {r.deadline_steps}")
        self.stats["expired"] += 1
        self._resolve(r)

    def _next_request(self) -> Optional[ServeRequest]:
        """Round-robin across tenants (per-tenant FIFO): one tenant's
        burst cannot starve the others' admissions."""
        for _ in range(len(self._tenants)):
            t = self._tenants[self._rr % len(self._tenants)]
            self._rr += 1
            q = self._queues[t]
            while q:
                r = q.popleft()
                if r.deadline_steps is not None \
                        and self._tick - r.submitted_at > r.deadline_steps:
                    self._expire(r)
                    continue
                return r
        return None

    # ------------------------------------------------------------ batching
    def _admit(self, slot: int, r: ServeRequest) -> None:
        """Prefill the request into a size-1 scratch cache (through the
        repository verbs), splice its rows into the slot, seed the first
        token, and pin the reused snapshot for the slot's lifetime."""
        s = len(r.prompt)
        scratch = self.model.init_cache(1, self.max_len)
        start = 0
        hit = self._probe_splice(r.prompt, strict=True)
        if hit is not None:
            scratch, start = hit.cache, hit.length
        logits, scratch = self._prefill(r.prompt, scratch, start)
        if self.kv is not None:
            self.kv.store_prefix(r.prompt, scratch, logits=logits)

        # copy scratch row 0 into slot `slot` of the live cache
        def splice(live, sc):
            if live.ndim >= 2 and live.shape[1] == self.n_slots \
                    and sc.shape[1] == 1:
                live[:, slot] = sc[:, 0]
        tree_map(splice, self.cache, scratch)
        self.slot_req[slot] = r
        self._slot_pin[slot] = hit.entry if hit is not None else None
        self.slot_pos[slot] = s
        self.next_tok[slot] = int(torch.argmax(logits[0, -1]))
        r.stats = ServeStats(prefilled_tokens=s - start,
                             reused_tokens=start,
                             decoded_tokens=0, wall_s=0.0)
        self.stats["reused_tokens"] += start
        self.stats["prefilled_tokens"] += s - start

    def _finish(self, slot: int) -> None:
        r = self.slot_req[slot]
        if r.stats is not None:
            r.stats.decoded_tokens = len(r.out)
        self.stats["served"] += 1
        self._resolve(r)
        if self._slot_pin[slot] is not None:
            self.kv.unpin(self._slot_pin[slot])
            self._slot_pin[slot] = None
        self.slot_req[slot] = None          # slot freed -> admission

    def step(self) -> bool:
        """Admit queued requests to free slots, then one batched decode
        step for every live slot.  Returns False when nothing is live."""
        self._tick += 1
        for slot in range(self.n_slots):
            if self.slot_req[slot] is None:
                r = self._next_request()
                if r is None:
                    break
                self._admit(slot, r)
        live = [i for i, r in enumerate(self.slot_req) if r is not None]
        if not live:
            return False

        # per-slot positions: a (B, 1) positions array (rope consumes
        # the batched form); an idle slot decodes harmlessly at its last
        # position, one row the live slots never read
        index = torch.as_tensor(self.slot_pos, device=self._device)
        batch = {"tokens": self._tokens(self.next_tok[:, None]),
                 "positions": index[:, None]}
        logits, self.cache = self._decode(batch, self.cache, index)
        toks = torch.argmax(logits[:, -1], -1).to(torch.int32).cpu().numpy()

        for slot in live:
            r = self.slot_req[slot]
            r.out.append(int(self.next_tok[slot]))
            self.slot_pos[slot] += 1
            self.next_tok[slot] = int(toks[slot])
            if len(r.out) >= r.max_new or int(toks[slot]) == self.eos \
                    or self.slot_pos[slot] >= self.max_len - 1:
                self._finish(slot)
        return True

    def pending(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def run(self, max_steps: int = 10_000) -> None:
        """Drive the continuous-batching loop until every submitted
        request is finished (or ``max_steps`` elapses)."""
        for _ in range(max_steps):
            if not self.step() and not self.pending():
                break
