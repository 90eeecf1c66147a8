"""The port's spans and counters (``repro_torch/trace.py``): off, they
cost one check and leave nothing; on, they nest by thread, carry the
request's id, read ``time.time_ns`` and report the registered launch
counters; and a small MLA model served through ``ServeSession`` records
the stages and counts that the code runs."""
import collections
import hashlib
import itertools
import threading
import tracemalloc

import numpy as np
import pytest
import torch

from repro_torch import trace
from repro_torch.configs import get_config
from repro_torch.core import prefix_plan
from repro_torch.kernels.build import LaunchCounter
from repro_torch.models.api import build
from repro_torch.serve.kv_repo import KVRepository
from repro_torch.serve.session import ServeSession


@pytest.fixture(autouse=True)
def _off():
    trace.stop()
    yield
    trace.stop()


def _no_clock(monkeypatch):
    def boom():
        raise AssertionError("a clock was read")
    for name in ("time_ns", "perf_counter", "perf_counter_ns", "time",
                 "monotonic", "monotonic_ns"):
        monkeypatch.setattr(trace.time, name, boom)


# ------------------------------------------------------------------ off


def test_off_span_is_one_shared_object_and_stop_yields_nothing():
    a = trace.span("a")
    assert trace.span("b") is a and trace.request(3) is a
    with trace.request(3), trace.span("a") as got:
        assert got is None
        trace.count("x", 5)
    rec = trace.stop()
    assert rec.spans == [] and rec.counters == collections.Counter()


def test_off_span_allocates_nothing_and_reads_no_clock(monkeypatch):
    _no_clock(monkeypatch)
    span, count, request = trace.span, trace.count, trace.request
    span("warm")
    loop = itertools.repeat(None, 2000)
    tracemalloc.start()
    try:
        for _ in loop:
            span("lm.sublayer")
            request(7)
            count("session.host_reads")
        now, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    assert peak == now == 0
    for _ in range(100):
        with span("mla.expand"):
            pass


# ------------------------------------------------------------------- on


def test_on_parents_nest_and_a_request_shares_its_id():
    trace.start()
    with trace.request(11):
        with trace.span("outer"):
            with trace.span("inner"):
                pass
            with trace.span("sibling"):
                pass
    with trace.span("alone"):
        pass
    seen = {}

    def worker():
        with trace.request(12), trace.span("thread"):
            with trace.span("thread.inner"):
                seen["ok"] = True
    t = threading.Thread(target=worker)
    with trace.span("main.open"):
        t.start()
        t.join(timeout=30)
    assert not t.is_alive() and seen["ok"]
    rec = trace.stop()
    by = {s.name: s for s in rec.spans}
    assert by["outer"].parent == 0
    assert by["inner"].parent == by["sibling"].parent == by["outer"].id
    assert {by[n].request for n in ("outer", "inner", "sibling")} == {11}
    assert by["alone"].request is None and by["alone"].parent == 0
    # another thread's spans nest on its own stack, under its own request
    assert by["thread"].parent == 0 and by["thread"].request == 12
    assert by["thread.inner"].parent == by["thread"].id
    assert len({s.id for s in rec.spans}) == len(rec.spans)
    for s in rec.spans:
        assert s.t0 <= s.t1
    assert trace.stop().spans == []


def test_time_ns_is_the_clock(monkeypatch):
    ticks = itertools.count(1000, 10)
    monkeypatch.setattr(trace.time, "time_ns", lambda: next(ticks))
    trace.start()
    with trace.span("a"):
        with trace.span("b"):
            pass
    rec = trace.stop()
    by = {s.name: s for s in rec.spans}
    assert (by["a"].t0, by["b"].t0, by["b"].t1, by["a"].t1) == \
        (1000, 1010, 1020, 1030)
    assert trace.self_ns(rec.spans) == {by["a"].id: 20, by["b"].id: 10}


def test_counters_and_registered_launches(monkeypatch):
    monkeypatch.setattr(trace, "_launches", dict(trace._launches))
    c = LaunchCounter("trace_test_kernel")
    assert trace.launch_counters()["trace_test_kernel"] is c
    c.add()                                   # before start: not counted
    trace.start()
    c.add()
    c.add(shape=(1, 2))
    trace.count("kv.hashed_tokens", 64)
    trace.count("kv.hashed_tokens", 36)
    trace.count("session.host_reads")
    late = LaunchCounter("trace_test_late")   # registered while on
    late.add()
    rec = trace.stop()
    assert rec.counters["launches.trace_test_kernel"] == 2
    assert rec.counters["launches.trace_test_late"] == 1
    assert rec.counters["kv.hashed_tokens"] == 100
    assert rec.counters["session.host_reads"] == 1
    assert c.count == 3


# -------------------------------------------------------------- serving


def _tree(spans):
    kids = collections.defaultdict(list)
    for s in spans:
        kids[s.parent].append(s)
    return kids


def _under(kids, span, name):
    """The spans called ``name`` anywhere below ``span``."""
    out, todo = [], list(kids[span.id])
    while todo:
        s = todo.pop()
        if s.name == name:
            out.append(s)
        todo.extend(kids[s.id])
    return out


@pytest.fixture(scope="module")
def mla():
    cfg = get_config("minicpm3-4b", smoke=True)
    model = build(cfg, device="cpu")
    return cfg, model, model.init(0)


def test_serving_an_mla_model_twice_records_its_stages(mla, monkeypatch):
    cfg, model, params = mla
    rng = np.random.default_rng(3)
    common = rng.integers(1, cfg.vocab_size, 24)
    prompts = [np.concatenate([common, rng.integers(1, cfg.vocab_size, n)])
               for n in (8, 5)]
    n_decode = 4
    sha = collections.Counter()
    real = hashlib.sha256

    def counting(data=b""):
        sha["step" if b":" in data else "seed"] += 1
        return real(data)
    monkeypatch.setattr(prefix_plan.hashlib, "sha256", counting)

    kv = KVRepository()
    sess = ServeSession(model, params, max_len=64, kv=kv)
    trace.start()
    with torch.no_grad():
        outs = [sess.serve(p, n_decode) for p in prompts]
    rec = trace.stop()
    spans, c = rec.spans, rec.counters
    kids = _tree(spans)
    names = collections.Counter(s.name for s in spans)

    # the second request reused the 24-token prefix, as the stats say
    assert outs[1][1].reused_tokens == 24
    assert c["session.prompt_tokens"] == sum(map(len, prompts)) == \
        sess.stats["reused_tokens"] + sess.stats["prefilled_tokens"]
    assert sess.stats["reused_tokens"] == sum(o[1].reused_tokens
                                              for o in outs)

    # one lm.decode a decode step, each with n_layers sublayers and
    # n_layers latent expansions inside it
    steps = [s for s in spans if s.name == "lm.decode"]
    assert len(steps) == sum(o[1].decoded_tokens for o in outs) \
        == 2 * n_decode
    for st in steps:
        subs = [s for s in kids[st.id] if s.name == "lm.sublayer"]
        assert len(subs) == cfg.n_layers
        assert len(_under(kids, st, "mla.expand")) == cfg.n_layers
        for sub in subs:
            assert [s.name for s in kids[sub.id]].count("lm.ffn") == 1
            stages = {s.name for s in _under(kids, sub, "mla.project")
                      + _under(kids, sub, "mla.cache_write")
                      + _under(kids, sub, "mla.attend")
                      + _under(kids, sub, "mla.out")}
            assert len(stages) == 4
        assert [s.name for s in kids[st.id]].count("lm.unembed") == 1
    assert names["lm.prefill"] == 2

    # a pick after each request's prefill, then one after every decode
    # step: the pick after the last step is not emitted
    assert names["session.sample"] == sum(len(o[0]) for o in outs) + 2
    assert c["session.host_reads"] == names["session.sample"]  # no card

    # one hash a token: probe and store_prefix each hash every prompt
    assert c["kv.hashed_tokens"] == sha["step"] == 2 * sum(map(len, prompts))

    # each request's spans carry its id, none is left without one
    assert {s.request for s in spans} == {0, 1}
    for rid in (0, 1):
        mine = collections.Counter(s.name for s in spans
                                   if s.request == rid)
        assert mine["lm.decode"] == n_decode and mine["lm.prefill"] == 1
    # the repository's stages and counts
    stores = [s for s in spans if s.name == "kvrepo.store_prefix"]
    assert len(stores) == 2 and {s.parent for s in stores} == {0}
    for st in stores:
        assert sorted(s.name for s in kids[st.id]) == \
            ["kvrepo.aliases", "kvstore.put"]
    gets = [s for s in spans if s.name.startswith("kvstore.get.")]
    assert [(s.name, s.request) for s in gets] == [("kvstore.get.device", 1)]
    assert names["session.clone"] == 1
    assert c["kv.aliases_added"] == len(kv) - 2
    assert c["launches.flash_attention"] == 0          # the CPU's path
    assert "fa.forward" not in names


def test_dense_attention_records_the_layer_stages():
    cfg = get_config("qwen3-1.7b", smoke=True)
    model = build(cfg, device="cpu")
    sess = ServeSession(model, model.init(0), max_len=32)
    trace.start()
    with torch.no_grad():
        sess.serve(np.arange(1, 9), 2)
    rec = trace.stop()
    names = collections.Counter(s.name for s in rec.spans)
    calls = names["lm.prefill"] + names["lm.decode"]
    assert calls == 3
    for stage in ("lm.sublayer", "lm.ffn"):
        assert names[stage] == calls * cfg.n_layers
    assert names["lm.unembed"] == calls
    # the GQA families' attention has no stage spans of its own
    assert not [n for n in names if n.startswith(("mla.", "attn."))]
