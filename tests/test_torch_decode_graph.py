"""What the CUDA graph of the decode step rests on, on the CPU at the
smoke configs (f32), where no graph is captured.

- MLA's latent write at a 0-d tensor index (``layers.mla_forward``):
  output and both latent leaves bit-equal to the int path's, at an index
  mid-cache, at the last row and past it (the write's start clamped to
  Smax - S, as the int path clamps it); a per-row (B,) index still
  raises.
- The step the graphs replay, split at each layer's attention
  (``layers.split_attention``): at a 0-d index, with the attention run
  at the int index between the pieces, it gives the eager step's logits
  and cache bit for bit, one split a layer; an int index takes none.
- ``ServeSession.serve``'s one request cache: a cold document, a spliced
  ask, an exact hit on an alias (the replay of the last token), an exact
  hit on a stored prompt and a short cold prompt after the long ones,
  one after another through one session, give the tokens, the
  ``ServeStats``, the stored snapshots and the final request cache of a
  fresh session per request, bit for bit: nothing of an earlier request
  reaches a later one.  The model's graph goes with the session whose
  cache it was captured on.
- Which stacks the graph may take (``lm.mla_stack``: MLA and MLP
  sublayers only), and that on the CPU ``Model.decode_step`` captures
  nothing: ``lm.decode_graph.captures`` and ``replays`` stay 0.

The graph itself, replayed against eager steps, is
``test_torch_decode_graph_cuda.py``.
"""
import collections

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import trace  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import lm as LM  # noqa: E402
from repro_torch.models.api import build  # noqa: E402
from repro_torch.serve.kv_repo import KVRepository  # noqa: E402
from repro_torch.serve.session import ServeSession  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

SMAX = 16


@pytest.fixture(scope="module")
def mla():
    cfg = get_config("minicpm3-4b", smoke=True)
    params = build(cfg, device="cpu").init(0)
    mixer = tree_map(lambda t: t[0], params["blocks"]["slot0"]["mixer"])
    return cfg, mixer


def _mla_call(cfg, p, x, positions, cache, index):
    cache = tree_map(torch.clone, cache)
    with torch.no_grad():
        out, new = L.mla_forward(cfg, p, x, positions, cache, index)
    assert new[0] is cache[0] and new[1] is cache[1]
    return out, cache


# (index, new tokens): mid-cache, the last row, past it (clamped to Smax
# - S, as dynamic_update_slice clamps), and a multi-token write from 0
@pytest.mark.parametrize("index,s", [(7, 1), (7, 3), (SMAX - 1, 1),
                                     (SMAX - 1, 3), (SMAX + 2, 1), (0, 3)])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_mla_tensor_index_equals_int_index(mla, index, s, dtype):
    cfg, p = mla
    m = cfg.mla
    g = torch.Generator().manual_seed(index * 10 + s)
    x = torch.randn((2, s, cfg.d_model), generator=g)
    cache = (torch.randn((2, SMAX, m.kv_lora_rank), generator=g),
             torch.randn((2, SMAX, m.qk_rope_head_dim), generator=g))
    positions = torch.arange(index, index + s, dtype=torch.int32)
    want, want_cache = _mla_call(cfg, p, x, positions, cache, index)
    got, got_cache = _mla_call(cfg, p, x, positions, cache,
                               torch.tensor(index, dtype=dtype))
    assert torch.equal(got, want)
    for a, b in zip(got_cache, want_cache):
        assert torch.equal(a, b)
    start = min(index, SMAX - s)
    assert not torch.equal(want_cache[0][:, start:start + s],
                           cache[0][:, start:start + s])


@pytest.mark.parametrize("shape", [(2,), (1,)])
def test_mla_per_row_index_still_raises(mla, shape):
    cfg, p = mla
    m = cfg.mla
    cache = (torch.zeros((2, SMAX, m.kv_lora_rank)),
             torch.zeros((2, SMAX, m.qk_rope_head_dim)))
    with pytest.raises(ValueError, match="continuous batching of MLA is "
                                         "not supported"):
        L.mla_forward(cfg, p, torch.zeros((2, 1, cfg.d_model)),
                      torch.zeros((1,), dtype=torch.int32), cache,
                      torch.zeros(shape, dtype=torch.int32))


def _requests(cfg, rng):
    """A cold document, an ask spliced from it, an exact hit on its
    24-token alias (positional caches: the last token replayed), the
    document itself (an exact hit with stored logits) and a short cold
    prompt after them."""
    doc = rng.integers(1, cfg.vocab_size, 40)
    ask = np.concatenate([doc, rng.integers(1, cfg.vocab_size, 6)])
    return [doc, ask, doc[:24], doc, rng.integers(1, cfg.vocab_size, 10)]


def _snapshots(kv):
    return {e.artifact: kv.store.get(e.artifact)
            for e in kv.repository.entries}


@pytest.mark.parametrize("arch", ["minicpm3-4b", "qwen3-1.7b",
                                  "xlstm-350m", "qwen3-moe-235b-a22b",
                                  "jamba-1.5-large-398b"])
def test_one_request_cache_equals_a_fresh_session_per_request(arch):
    cfg = get_config(arch, smoke=True)
    model = build(cfg, device="cpu")
    params = model.init(0)
    prompts = _requests(cfg, np.random.default_rng(3))
    kv_one, kv_fresh = KVRepository(), KVRepository()
    one = ServeSession(model, params, max_len=64, kv=kv_one)
    with torch.no_grad():
        for prompt in prompts:
            got, got_stats = one.serve(prompt, 5)
            fresh = ServeSession(model, params, max_len=64, kv=kv_fresh)
            want, want_stats = fresh.serve(prompt, 5)
            np.testing.assert_array_equal(got, want)
            got_stats.wall_s = want_stats.wall_s = 0.0
            assert got_stats == want_stats
    # the requests took every path: cold, spliced, exact on an alias
    # (positional) or cold again (recurrent: exact-length entries only),
    # exact on the stored document, cold
    assert one.stats["reused_tokens"] == 40 + (24 if one._positional
                                               else 0) + 40
    for a, b in zip(tree_leaves(one._request_cache),
                    tree_leaves(fresh._request_cache)):
        assert torch.equal(a, b)
    snaps, want_snaps = _snapshots(kv_one), _snapshots(kv_fresh)
    assert snaps.keys() == want_snaps.keys() and len(snaps) >= 3
    for name, (cache, logits) in snaps.items():
        for a, b in zip(tree_leaves(cache), tree_leaves(want_snaps[name][0])):
            assert torch.equal(a, b)
        assert torch.equal(logits, want_snaps[name][1])


def _emulated_split(calls, index):
    """The split a capture hands each MLA layer, as its warm-up runs it:
    the layer's decompression and attention at the int ``index``."""
    def split(attend, shape, dtype):
        out = attend(index)
        assert out.shape == shape and out.dtype == dtype
        calls.append(shape)
        return out
    return split


@pytest.mark.parametrize("index", [0, 5, 11, SMAX - 1])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_split_step_equals_the_eager_step(index, dtype):
    """``lm_decode`` at a 0-d index with each layer's attention handed to
    a split (the graphs' warm-up and replays) gives the int path's
    logits and latent cache bit for bit, one split call a layer."""
    cfg = get_config("minicpm3-4b", smoke=True)
    model = build(cfg, device="cpu")
    params = model.init(0)
    g = torch.Generator().manual_seed(index)
    cache = tree_map(lambda t: torch.randn(t.shape, generator=g),
                     model.init_cache(1, SMAX))
    want_cache = tree_map(torch.clone, cache)
    tokens = torch.tensor([[index + 3]])
    positions = torch.tensor([index], dtype=torch.int32)
    calls = []
    with torch.no_grad():
        want, _ = LM.lm_decode(cfg, params, tokens, positions, want_cache,
                               index)
        with L.split_attention(_emulated_split(calls, index)):
            got, _ = LM.lm_decode(cfg, params, tokens, positions, cache,
                                  torch.tensor(index, dtype=dtype))
        # an int index takes no split: the prefill's and eager path
        with L.split_attention(_emulated_split(calls, None)):
            LM.lm_decode(cfg, params, tokens, positions,
                         tree_map(torch.clone, cache), index)
    assert torch.equal(got, want)
    for a, b in zip(tree_leaves(cache), tree_leaves(want_cache)):
        assert torch.equal(a, b)
    m = cfg.mla
    assert calls == [(1, cfg.n_heads, 1, m.v_head_dim)] * cfg.n_layers
    assert L._graph_split is None


def test_a_sessions_end_frees_the_graph_on_its_cache():
    """The model's decode graph lives as long as the session whose
    request cache it was captured on (``Model.release_graph``); a graph
    on another cache is left alone."""
    import gc
    import types
    cfg = get_config("minicpm3-4b", smoke=True)
    model = build(cfg, device="cpu")
    params = model.init(0)
    sessions = [ServeSession(model, params, max_len=32) for _ in range(2)]
    with torch.no_grad():
        for sess in sessions:
            sess.serve(np.arange(1, 9), 2)
    # a graph as the card's path keeps one: bound to its cache
    model._graph = types.SimpleNamespace(
        cache=sessions[0]._request_cache)
    del sessions[1]
    gc.collect()
    assert model._graph is not None
    del sessions[0]
    gc.collect()
    assert model._graph is None


def test_only_mla_stacks_are_graphed():
    graphed = [a for a in ARCH_IDS
               if LM.mla_stack(get_config(a, smoke=True))]
    assert graphed == ["minicpm3-4b"]
    assert LM.mla_stack(get_config("minicpm3-4b"))


def test_the_cpu_captures_nothing():
    cfg = get_config("minicpm3-4b", smoke=True)
    model = build(cfg, device="cpu")
    sess = ServeSession(model, model.init(0), max_len=32, kv=KVRepository())
    prompt = np.arange(1, 13)
    trace.start()
    try:
        with torch.no_grad():
            for _ in range(2):
                sess.serve(prompt, 4)
    finally:
        rec = trace.stop()
    names = collections.Counter(s.name for s in rec.spans)
    assert names["lm.decode"] == 8     # the exact hit reads stored logits
    assert rec.counters["lm.decode_graph.captures"] == 0
    assert rec.counters["lm.decode_graph.replays"] == 0
    assert model._graph is None
    batch = {"tokens": torch.zeros((1, 1), dtype=torch.int64),
             "positions": torch.zeros((1,), dtype=torch.int32)}
    with torch.no_grad():
        assert model._graph_key(None, batch, None, 0) is None

