"""The port's remaining decoder-only families against the reference's, on
the CPU at the smoke configs (f32): MLA (minicpm3-4b), MoE (qwen3-moe,
llama4-maverick's dense/MoE interleave) and M-RoPE with the embeddings
frontend (qwen2-vl).

Parameters are made by the reference's ``Model.init`` and carried into
the port by ``models/convert.py``, and inputs are seeded numpy arrays,
so both packages run the same numbers.

Tolerances: logits, layer outputs and losses within rtol = atol = 2e-5,
the f32 round-off of two differently ordered computations of values of
size ~1 (as ``test_torch_models.py``); M-RoPE's cos/sin within 1e-6
(the same f32 angle through two libraries' cos and sin).  MoE slots,
drop counts, routing and greedy tokens are compared exactly.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models import lm as ref_lm  # noqa: E402
from repro.models.api import build as ref_build  # noqa: E402
from repro.serve.kv_repo import KVRepository as RefKVRepository  # noqa
from repro.serve.session import ServeSession as RefServeSession  # noqa
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    mha_ref, mha_split_ref)
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import lm as LM  # noqa: E402
from repro_torch.models.api import build  # noqa: E402
from repro_torch.models.convert import (cache_from_numpy,  # noqa: E402
                                        params_from_numpy)
from repro_torch.serve.kv_repo import KVRepository  # noqa: E402
from repro_torch.serve.session import ServeSession  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)
FAMILIES = ["minicpm3-4b", "qwen3-moe-235b-a22b",
            "llama4-maverick-400b-a17b", "qwen2-vl-72b"]
MOE = ["qwen3-moe-235b-a22b", "llama4-maverick-400b-a17b"]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(port, ref_out, **tol):
    np.testing.assert_allclose(port.detach().float().numpy(),
                               np.asarray(ref_out, np.float32),
                               **(tol or TOL))


_PAIRS = {}


def _pair(arch, **overrides):
    """(ref model, ref params, port model, port params) at the smoke
    config (with ``overrides``), the port's parameters carried over from
    the reference's; cached per module."""
    key = (arch, tuple(sorted(overrides.items())))
    if key not in _PAIRS:
        rcfg = ref_get_config(arch, smoke=True)
        cfg = get_config(arch, smoke=True)
        if overrides:
            rcfg = dataclasses.replace(rcfg, **overrides)
            cfg = dataclasses.replace(cfg, **overrides)
        rm = ref_build(rcfg)
        rp = rm.init(jax.random.PRNGKey(3))
        pm = build(cfg, device="cpu")
        _PAIRS[key] = (rm, rp, pm, params_from_numpy(_np(rp), "cpu"))
    return _PAIRS[key]


def _inputs(cfg, seed, b, s):
    """Seeded inputs of one model call: (name, numpy array): token ids,
    or (B, S, d) f32 embeddings for the embeddings frontend."""
    rng = np.random.default_rng(seed)
    if cfg.frontend == "embeds":
        return "embeds", rng.standard_normal(
            (b, s, cfg.d_model)).astype(np.float32)
    return "tokens", rng.integers(0, cfg.vocab_size, (b, s),
                                  dtype=np.int32)


def _positions(cfg, b, s0, s1):
    pos = np.arange(s0, s1, dtype=np.int32)
    if cfg.m_rope:
        pos = np.ascontiguousarray(np.broadcast_to(pos, (3, b, s1 - s0)))
    return pos


def _batches(cfg, name, x, pos):
    return ({name: jnp.asarray(x), "positions": jnp.asarray(pos)},
            {name: torch.from_numpy(x), "positions": torch.from_numpy(pos)})


# ------------------------------------------------------------ layers


@pytest.mark.parametrize("sections,dim", [((16, 24, 24), 128),
                                          ((2, 3, 3), 16)])
def test_mrope_cos_sin_matches_reference(sections, dim):
    rng = np.random.default_rng(0)
    pos = rng.integers(0, 5000, (3, 2, 7), dtype=np.int32)
    want = RL.mrope_cos_sin(jnp.asarray(pos), dim, 1e6, sections,
                            jnp.float32)
    got = L.mrope_cos_sin(torch.from_numpy(pos), dim, 1e6, sections,
                          torch.float32)
    for g, w in zip(got, want):
        assert tuple(g.shape) == (2, 7, dim // 2)
        _close(g, w, rtol=0, atol=1e-6)


def _layer_params(rp, slot="slot0"):
    sub = jax.tree_util.tree_map(lambda a: a[0], rp["blocks"][slot])
    return sub, params_from_numpy(_np(sub), "cpu")


def test_mla_forward_matches_reference():
    """MLA without a cache, then the cache filled from 0 and a decode
    step from index 9: outputs and the latent cache."""
    rm, rp, pm, _ = _pair("minicpm3-4b")
    cfg = pm.cfg
    sub, psub = _layer_params(rp)
    r_mix, p_mix = sub["mixer"], psub["mixer"]
    x = np.random.default_rng(1).standard_normal(
        (2, 10, cfg.d_model)).astype(np.float32)
    pos = np.arange(10, dtype=np.int32)
    want, _ = RL.mla_forward(rm.cfg, r_mix, jnp.asarray(x), jnp.asarray(pos))
    got, _ = L.mla_forward(cfg, p_mix, torch.from_numpy(x),
                           torch.from_numpy(pos))
    _close(got, want)
    m = cfg.mla
    rc = (jnp.zeros((2, 16, m.kv_lora_rank)),
          jnp.zeros((2, 16, m.qk_rope_head_dim)))
    pc = tuple(torch.zeros(a.shape) for a in rc)
    for s0, s1 in ((0, 9), (9, 10)):
        xs = jnp.asarray(x[:, s0:s1])
        want, rc = RL.mla_forward(rm.cfg, r_mix, xs, jnp.asarray(pos[s0:s1]),
                                  rc, jnp.int32(s0))
        got, pc = L.mla_forward(cfg, p_mix, torch.from_numpy(x[:, s0:s1]),
                                torch.from_numpy(pos[s0:s1]), pc, s0)
        _close(got, want)
    for a, t in zip(rc, pc):
        _close(t, a)


def test_mla_per_row_cache_index_raises():
    _, rp, pm, _ = _pair("minicpm3-4b")
    _, psub = _layer_params(rp)
    cache = LM.init_cache(pm.cfg, 2, 8, "cpu")["slot0"]
    with pytest.raises(ValueError, match="one index for every row"):
        L.mla_forward(pm.cfg, psub["mixer"], torch.zeros(2, 1, 64),
                      torch.zeros(2, 1, dtype=torch.int32),
                      tuple(c[0] for c in cache),
                      torch.tensor([3, 5], dtype=torch.int32))


def _ref_slots(flat_e, n_experts, cap):
    """The reference's dispatch formula (``_moe_forward_gspmd``), its
    slots put back in entry order."""
    flat_e = jnp.asarray(flat_e)
    order = jnp.argsort(flat_e)
    sorted_e = jnp.take(flat_e, order)
    seg_start = jnp.searchsorted(sorted_e, sorted_e, side="left")
    rank = jnp.arange(flat_e.shape[0]) - seg_start
    keep = rank < cap
    slot = jnp.where(keep, sorted_e * cap + rank, n_experts * cap)
    out = np.empty(flat_e.shape[0], np.int64)
    out[np.asarray(order)] = np.asarray(slot)
    return out, int((~np.asarray(keep)).sum())


@pytest.mark.parametrize("t,k,e", [(1, 1, 4), (7, 2, 8), (64, 2, 8),
                                   (96, 8, 16), (200, 8, 128),
                                   (512, 1, 128), (64, 2, 6),
                                   (200, 8, 60)])
@pytest.mark.parametrize("cap", [8, 16, 40])
def test_moe_slots_equal_reference_formula(t, k, e, cap):
    """Slots bit-equal to the reference's argsort formula and the same
    drop count, for top-k choices (k distinct experts per token) drawn
    skewed so that experts overflow; E of 6 and 60 take the plain
    version, as CPU tensors do at any E."""
    rng = np.random.default_rng(t * 131 + k * 7 + e + cap)
    w = 1.0 / np.arange(1, e + 1) ** 1.5
    eidx = np.stack([rng.choice(e, k, replace=False, p=w / w.sum())
                     for _ in range(t)]).astype(np.int32)
    want, dropped = _ref_slots(eidx.reshape(-1), e, cap)
    slot, got_dropped = L.moe_slots(torch.from_numpy(eidx), e, cap)
    np.testing.assert_array_equal(slot.numpy().astype(np.int64), want)
    assert int(got_dropped) == dropped


def _count_drops(monkeypatch):
    """Wraps ``layers.moe_slots``, which ``moe_forward`` calls, so that
    each call's count of dropped entries is appended to the list it
    returns."""
    drops, inner = [], L.moe_slots

    def moe_slots(*a):
        slot, dropped = inner(*a)
        drops.append(int(dropped))
        return slot, dropped
    monkeypatch.setattr(L, "moe_slots", moe_slots)
    return drops


@pytest.mark.parametrize("arch,cf,e", [(MOE[0], None, None),
                                       (MOE[1], None, None),
                                       (MOE[0], 1.0, None),
                                       (MOE[1], 1.0, None),
                                       (MOE[0], 1.0, 6)])
def test_moe_forward_matches_reference(arch, cf, e, monkeypatch):
    """The MoE layer on the same input: output and aux loss, and the
    drop count against the reference's formula over the reference's own
    routing.  At capacity_factor 1.0 entries drop (cap 24 for 192
    entries over 8 experts, 16 for 96, 32 over 6 experts: a count
    the card's kernel refuses, which the CPU computes plainly)."""
    moe = {} if e is None else dict(moe=dataclasses.replace(
        get_config(arch, smoke=True).moe, n_experts=e))
    rm, rp, pm, _ = _pair(arch, **moe)
    cfg, rcfg = pm.cfg, rm.cfg
    if cf is not None:
        cfg = cfg.with_(moe=dataclasses.replace(cfg.moe, capacity_factor=cf))
        rcfg = rcfg.with_(moe=dataclasses.replace(rcfg.moe,
                                                  capacity_factor=cf))
    slot = [j for j, (_, f) in enumerate(LM.slot_kinds(cfg)) if f == "moe"]
    sub, psub = _layer_params(rp, f"slot{slot[0]}")
    x = np.random.default_rng(2).standard_normal(
        (4, 24, cfg.d_model)).astype(np.float32)
    want, want_aux = RL._moe_forward_gspmd(rcfg, sub["ffn"], jnp.asarray(x))
    drops = _count_drops(monkeypatch)
    got, aux = L.moe_forward(cfg, psub["ffn"], torch.from_numpy(x))
    _close(got, want)
    _close(aux, want_aux)
    probs = jax.nn.softmax(jnp.asarray(x).reshape(-1, cfg.d_model)
                           @ sub["ffn"]["router"], -1)
    _, eidx = jax.lax.top_k(probs, cfg.moe.top_k)
    cap = L.moe_capacity(cfg, 4 * 24)
    _, dropped = _ref_slots(np.asarray(eidx).reshape(-1), cfg.moe.n_experts,
                            cap)
    assert drops == [dropped]
    if cf == 1.0:
        assert dropped > 0


def test_moe_combine_is_deterministic():
    _, rp, pm, _ = _pair(MOE[0])
    _, psub = _layer_params(rp)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 16, pm.cfg.d_model)).astype(np.float32))
    a, _ = L.moe_forward(pm.cfg, psub["ffn"], x)
    b, _ = L.moe_forward(pm.cfg, psub["ffn"], x)
    assert torch.equal(a, b)


# ------------------------------------------------------------ models


@pytest.mark.parametrize("arch", FAMILIES)
def test_param_tree_and_cache_match_reference(arch):
    """Same keys, shapes and dtypes as the reference's init and
    init_cache (the MLA latent slots included)."""
    rm, rp, pm, _ = _pair(arch)
    port = pm.init(0)
    for ref_tree, port_tree in ((_np(rp), port),
                                (_np(rm.init_cache(2, 16)),
                                 pm.init_cache(2, 16))):
        ref_leaves, ref_def = jax.tree_util.tree_flatten(ref_tree)
        port_leaves, port_def = jax.tree_util.tree_flatten(port_tree)
        assert str(ref_def).replace("PyTreeDef", "") == \
            str(port_def).replace("PyTreeDef", "")
        for a, t in zip(ref_leaves, port_leaves):
            assert tuple(a.shape) == tuple(t.shape)
            assert str(a.dtype) == str(t.dtype).replace("torch.", "")


@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_decode_match_reference(arch):
    """Prefill T = 12, then 3 decode steps, in both packages: every
    step's logits against the reference's and against the reference's
    full forward over the same T + 3 positions (the smoke MoE configs
    are dropless, so their routing does not depend on the call's
    tokens); the caches after the prefill agree, and the reference's
    cache carried over by ``cache_from_numpy`` decodes the same."""
    rm, rp, pm, pp = _pair(arch)
    cfg = pm.cfg
    T, K, B = 12, 3, 2
    name, x = _inputs(cfg, 5, B, T + K)
    pos = _positions(cfg, B, 0, T + K)
    full, _ = ref_lm.lm_forward(rm.cfg, rp, jnp.asarray(x), jnp.asarray(pos))
    rc, pc = rm.init_cache(B, T + K), pm.init_cache(B, T + K)
    rb, pb = _batches(cfg, name, x[:, :T], pos[..., :T])
    want, rc = rm.prefill(rp, rb, rc)
    got, pc = pm.prefill(pp, pb, pc)
    _close(got, want)
    _close(got[:, -1], full[:, T - 1])
    for a, t in zip(jax.tree_util.tree_leaves(rc),
                    jax.tree_util.tree_leaves(pc)):
        _close(t, a)
    carried = cache_from_numpy(_np(rc), "cpu")
    for t in range(K):
        s = T + t
        rb, pb = _batches(cfg, name, x[:, s:s + 1], pos[..., s:s + 1])
        want, rc = rm.decode_step(rp, rb, rc, jnp.int32(s))
        got, pc = pm.decode_step(pp, pb, pc, s)
        again, carried = pm.decode_step(pp, pb, carried, s)
        _close(got, want)
        _close(again, want)
        _close(got[:, 0], full[:, s])


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_fn_matches_reference(arch):
    """``Model.loss_fn``: total = loss + 0.01 aux, loss and aux, and the
    MoE families' aux is positive."""
    rm, rp, pm, pp = _pair(arch)
    cfg = pm.cfg
    name, x = _inputs(cfg, 6, 2, 16)
    labels = np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 16),
                                               dtype=np.int32)
    rb, pb = _batches(cfg, name, x, _positions(cfg, 2, 0, 16))
    rb["labels"], pb["labels"] = jnp.asarray(labels), torch.from_numpy(labels)
    want, (wl, wa) = rm.loss_fn(rp, rb)
    got, (gl, ga) = pm.loss_fn(pp, pb)
    for g, w in ((got, want), (gl, wl), (ga, wa)):
        _close(g, w)
    assert (float(ga) > 0) == (arch in MOE)


def test_moe_capacity_makes_a_reused_prefix_change_logits_in_both(
        monkeypatch):
    """A fault of the reference that the port reproduces: with a
    capacity-dropping MoE (here capacity_factor 1.0) a token's output
    depends on the other tokens of its call, so a prompt prefilled cold
    in one call and the same prompt prefilled as a reused 32-token
    prefix plus an 8-token suffix give different logits.  Both packages
    give the same logits in each form."""
    cfg0 = get_config(MOE[0], smoke=True)
    moe = dataclasses.replace(cfg0.moe, capacity_factor=1.0)
    rm, rp, pm, pp = _pair(MOE[0], moe=moe)
    _, x = _inputs(pm.cfg, 9, 1, 40)
    outs, drops = {}, _count_drops(monkeypatch)
    for form, cuts in (("cold", ((0, 40),)), ("reuse", ((0, 32), (32, 40)))):
        rc, pc = rm.init_cache(1, 40), pm.init_cache(1, 40)
        drops.clear()
        for s0, s1 in cuts:
            rb, pb = _batches(pm.cfg, "tokens", x[:, s0:s1],
                              _positions(pm.cfg, 1, s0, s1))
            want, rc = rm.prefill(rp, rb, rc, start=jnp.int32(s0))
            got, pc = pm.prefill(pp, pb, pc, start=s0)
        _close(got, want)
        outs[form] = (np.asarray(want), sum(drops))
    assert outs["cold"][1] > 0
    assert np.abs(outs["cold"][0] - outs["reuse"][0]).max() > 1e-3


def test_demo_batch_for_the_embeddings_frontend():
    pm = build(get_config("qwen2-vl-72b", smoke=True), device="cpu")
    b = pm.demo_batch(0, seq=8, gbs=2)
    assert "tokens" not in b and tuple(b["embeds"].shape) == (2, 8, 64)
    assert tuple(b["positions"].shape) == (3, 2, 8)
    total, _ = pm.loss_fn(pm.init(0), b)
    assert torch.isfinite(total)


@pytest.mark.parametrize("arch", ["xlstm-350m", "jamba-1.5-large-398b",
                                  "seamless-m4t-medium"])
def test_unported_families_still_raise(arch):
    """None of these raises any more: items 20 (the recurrent mixers)
    and 21 (the encoder-decoder family) are ported.  xlstm-350m, jamba
    and seamless-m4t-medium build, and their caches carry the
    reference's dtypes (``test_torch_ssm.py`` and
    ``test_torch_encdec.py`` hold them to the reference in full)."""
    cfg = get_config(arch, smoke=True)
    cache = build(cfg, device="cpu").init_cache(1, 8)
    want = ref_build(ref_get_config(arch, smoke=True)).init_cache(1, 8)
    assert [str(t.dtype).replace("torch.", "") for t in tree_leaves(cache)] \
        == [str(a.dtype) for a in jax.tree_util.tree_leaves(want)]


# ------------------------------------------------------------ serving


@pytest.mark.parametrize("arch", ["minicpm3-4b", "qwen3-moe-235b-a22b"])
def test_serve_session_reuse_matches_reference(arch):
    """Two prompts sharing a 24-token prefix through each package's
    ``ServeSession`` with a ``KVRepository``: the same greedy tokens
    and the same reused-token counts, and the same tokens as a cold
    port session."""
    rm, rp, pm, pp = _pair(arch)
    rng = np.random.default_rng(8)
    common = rng.integers(1, pm.cfg.vocab_size, 24)
    prompts = [np.concatenate([common, rng.integers(1, pm.cfg.vocab_size,
                                                    8)]) for _ in range(2)]
    ref = RefServeSession(rm, rp, max_len=48, kv=RefKVRepository())
    port = ServeSession(pm, pp, max_len=48, kv=KVRepository())
    cold = ServeSession(pm, pp, max_len=48)
    for p in prompts:
        want, ws = ref.serve(p, 5)
        got, gs = port.serve(p, 5)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, cold.serve(p, 5)[0])
        assert (gs.reused_tokens, gs.prefilled_tokens) == \
            (ws.reused_tokens, ws.prefilled_tokens)
    assert gs.reused_tokens >= 24


def test_session_positions_for_mrope():
    rm, rp, pm, pp = _pair("qwen2-vl-72b")
    want = RefServeSession(rm, rp, max_len=16)._positions(5, 3)
    got = ServeSession(pm, pp, max_len=16)._positions(5, 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------------ attention


@pytest.mark.parametrize("d,dv", [(96, 64), (24, 16)])
@pytest.mark.parametrize("causal,kv_len,q_off", [(True, None, None),
                                                 (True, 150, 140),
                                                 (False, 77, 0)])
def test_attention_at_unequal_head_dims_matches_reference(d, dv, causal,
                                                          kv_len, q_off):
    """``mha_ref`` and ``mha_split_ref`` at D_v != D_qk against the
    reference's ``_sdpa`` (scale 1/sqrt(D_qk)); the wrapper's plain
    route gives ``mha_ref``'s bits."""
    rng = np.random.default_rng(d + dv)
    sq, skv = (10 if q_off else 160), 160
    q = rng.standard_normal((2, 4, sq, d)).astype(np.float32)
    k = rng.standard_normal((2, 4, skv, d)).astype(np.float32)
    v = rng.standard_normal((2, 4, skv, dv)).astype(np.float32)
    want = RL._sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    causal=causal, q_offset=q_off or 0, kv_len=kv_len)
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    kw = dict(causal=causal, q_offset=q_off or 0)
    got = mha_ref(qt, kt, vt, kv_len, **kw)
    assert tuple(got.shape) == (2, 4, sq, dv)
    _close(got, want)
    _close(mha_split_ref(qt, kt, vt, kv_len, **kw), want)
    assert torch.equal(fa.mha(qt, kt, vt, kv_len, **kw), got)


def test_check_takes_mla_head_dims_only():
    def qkv(d, dv):
        return (torch.zeros(1, 2, 4, d), torch.zeros(1, 2, 4, d),
                torch.zeros(1, 2, 4, dv))
    fa._check(*qkv(96, 64))
    assert fa.head_dims_ok(96, 64) and fa.head_dims_ok(128, 128)
    for d, dv in ((96, 48), (96, 96), (64, 96), (136, 64), (100, 64)):
        assert not fa.head_dims_ok(d, dv)
        with pytest.raises(ValueError, match="head dim"):
            fa._check(*qkv(d, dv))
    # bf16 trains MLA on the tensor cores, float32 on the CUDA cores
    assert fa.bwd_plan(torch.bfloat16, 96, "cuda", 64) == "sm90"
    assert fa.bwd_plan(torch.float32, 96, "cuda", 64) == "simt"
    assert fa.bwd_plan(torch.bfloat16, 96, "cpu", 64) == "plain"
