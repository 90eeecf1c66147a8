"""The decode step replayed as CUDA graphs between the layers'
attention calls (``Model.decode_step``), on the card, at minicpm3's
smoke config in bf16 (the bf16 attention kernel at (D_qk, D_v) = (24,
16)):

- replayed steps equal eager steps (``lm.lm_decode`` at an int index)
  bit for bit over 40 tokens: the logits of every step, and both latent
  leaves after the last;
- the attention runs from Python at every step, replayed or not: a
  wrapper on ``fa.mha`` sees each layer's call at the step's int
  ``kv_len`` and ``q_offset``, and the kernel's ``LaunchCounter`` counts
  a launch a layer;
- several requests through one ``ServeSession`` (a cold document, a
  spliced ask, an exact hit on an alias) capture once: the session's
  first decode captures, every later one replays, and the tokens are
  those of the eager path (gradients on: no graph); the graphs go with
  the session;
- a replayed step asks the host to wait for nothing
  (``torch.cuda.set_sync_debug_mode("error")``);
- GQA (qwen3-1.7b), MoE (qwen3-moe) and recurrent (xlstm-350m) smoke
  models serve with no capture and the eager path's tokens.

These tests need a CUDA card and skip without one; this file imports the
port only.
"""
import gc

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import trace  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa  # noqa: E402
from repro_torch.models import lm as LM  # noqa: E402
from repro_torch.models.api import build  # noqa: E402
from repro_torch.serve.kv_repo import KVRepository  # noqa: E402
from repro_torch.serve.session import ServeSession  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

STEPS = 40


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _mla(cuda):
    cfg = get_config("minicpm3-4b", smoke=True).with_(dtype="bfloat16")
    model = build(cfg, device=cuda)
    return cfg, model, model.init(0)


def _traced(fn):
    trace.start()
    try:
        fn()
    finally:
        rec = trace.stop()
    return rec.counters


@pytest.mark.cuda
def test_replayed_steps_equal_eager_steps_bit_for_bit(cuda):
    cfg, model, params = _mla(cuda)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 8 + STEPS))
                            ).to(cuda)
    pos = torch.arange(8 + STEPS, dtype=torch.int32, device=cuda)
    graphed = model.init_cache(1, 64)
    with torch.no_grad():
        model.prefill(params, {"tokens": toks[:, :8], "positions": pos[:8]},
                      graphed)
    eager = tree_map(torch.clone, graphed)
    got, want = [], []

    def steps():
        with torch.no_grad():
            for i in range(8, 8 + STEPS):
                batch = {"tokens": toks[:, i:i + 1],
                         "positions": pos[i:i + 1]}
                got.append(model.decode_step(params, batch, graphed, i)[0])
                want.append(LM.lm_decode(cfg, params, batch["tokens"],
                                         batch["positions"], eager, i)[0])
    before = fa.launches.count
    c = _traced(steps)
    assert c["lm.decode_graph.captures"] == 1
    assert c["lm.decode_graph.replays"] == STEPS - 1
    # every step launches the kernel once a layer, graphed or eager (the
    # capturing step's launches are its warm-up's)
    assert fa.launches.count - before == cfg.n_layers * 2 * STEPS
    for i, (a, b) in enumerate(zip(got, want)):
        assert torch.equal(a, b), f"step {i}"
    assert len({t.data_ptr() for t in got}) == STEPS   # the caller's own
    for a, b in zip(tree_leaves(graphed), tree_leaves(eager)):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_a_replayed_step_calls_the_attention_from_python(cuda,
                                                         monkeypatch):
    cfg, model, params = _mla(cuda)
    cache = model.init_cache(1, 64)
    seen = []
    inner = fa.mha

    def mha(q, k, v, kv_len=None, *, causal=True, q_offset=None):
        seen.append((kv_len, q_offset, q.shape[2], k.shape[2]))
        return inner(q, k, v, kv_len, causal=causal, q_offset=q_offset)
    monkeypatch.setattr(fa, "mha", mha)

    def step(i):
        batch = {"tokens": torch.full((1, 1), i + 1, device=cuda),
                 "positions": torch.full((1,), i, dtype=torch.int32,
                                         device=cuda)}
        return model.decode_step(params, batch, cache, i)[0]
    with torch.no_grad():
        c = _traced(lambda: [step(i) for i in range(5)])
    assert c["lm.decode_graph.captures"] == 1
    assert c["lm.decode_graph.replays"] == 4
    # each step's layers, the capturing one's (its warm-up) included, at
    # host ints: nothing is read back from the card to record them
    assert seen == [(i + 1, i, 1, 64) for i in range(5)
                    for _ in range(cfg.n_layers)]
    assert all(type(a) is int and type(b) is int for a, b, _, _ in seen)


def _prompts(cfg, rng):
    doc = rng.integers(1, cfg.vocab_size, 40)
    return [doc, np.concatenate([doc, rng.integers(1, cfg.vocab_size, 6)]),
            doc[:24], rng.integers(1, cfg.vocab_size, 12)]


def _serve(model, params, prompts, grad):
    sess = ServeSession(model, params, max_len=64, kv=KVRepository())
    with torch.set_grad_enabled(grad):
        return [sess.serve(p, 6)[0] for p in prompts], sess


@pytest.mark.cuda
def test_a_session_captures_once(cuda):
    cfg, model, params = _mla(cuda)
    prompts = _prompts(cfg, np.random.default_rng(1))
    eager, _ = _serve(model, params, prompts, grad=True)
    assert model._graph is None
    out = {}
    c = _traced(lambda: out.update(r=_serve(model, params, prompts,
                                            grad=False)))
    got, sess = out["r"]
    for a, b in zip(got, eager):
        np.testing.assert_array_equal(a, b)
    # 6 decode steps a request, and the alias hit replays its last token
    steps = 6 * len(prompts) + 1
    assert sess.stats["reused_tokens"] == 40 + 24
    assert c["lm.decode_graph.captures"] == 1
    assert c["lm.decode_graph.replays"] == steps - 1
    assert model._graph is not None and model._graph.cache is \
        sess._request_cache
    del sess, out
    gc.collect()
    assert model._graph is None


@pytest.mark.cuda
def test_a_replayed_step_does_not_synchronise(cuda):
    cfg, model, params = _mla(cuda)
    cache = model.init_cache(1, 32)
    batch = {"tokens": torch.ones((1, 1), dtype=torch.int64, device=cuda),
             "positions": torch.zeros((1,), dtype=torch.int32, device=cuda)}
    with torch.no_grad():
        first, _ = model.decode_step(params, batch, cache, 0)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            again, _ = model.decode_step(params, batch, cache, 0)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(first, again)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "qwen3-moe-235b-a22b",
                                  "xlstm-350m"])
def test_other_families_decode_eagerly(cuda, arch):
    cfg = get_config(arch, smoke=True)
    model = build(cfg, device=cuda)
    params = model.init(0)
    prompts = _prompts(cfg, np.random.default_rng(2))
    eager, _ = _serve(model, params, prompts, grad=True)
    out = {}
    c = _traced(lambda: out.update(r=_serve(model, params, prompts,
                                            grad=False)))
    for a, b in zip(out["r"][0], eager):
        np.testing.assert_array_equal(a, b)
    assert c["lm.decode_graph.captures"] == 0
    assert c["lm.decode_graph.replays"] == 0
    assert model._graph is None
