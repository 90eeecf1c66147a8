"""The port's recurrent mixers (``models/ssm.py``) and the two families
built on them, xlstm-350m (mLSTM and sLSTM blocks) and
jamba-1.5-large-398b (Mamba, attention and MoE), against the reference,
on the CPU at the smoke configs (f32).

Parameters are made by the port's seeded ``init_*`` / ``Model.init``
(whose trees, shapes and dtypes are held to the reference's
``init_shapes``) and cross into both packages as numpy arrays, the
port's through ``models/convert.py``; the reference's random init costs
more time than this file's tests.  Inputs and states are seeded numpy
arrays, so both packages run the same numbers.

The whole models' forward, prefill, decode and gradients are held in
``test_torch_ssm_models.py``, which shares this file's helpers.

Tolerances: the xLSTM cells, logits and caches within rtol = atol =
2e-5, the f32 round-off of two differently ordered computations of
values of size ~1; Mamba's chunked scan within rtol 1e-4 (atol 1e-5):
the port composes a chunk's affine maps by log-step doubling, the
reference by ``associative_scan``, which associates the products
otherwise.  Tokens, reuse counts, stored bytes and cache dtypes are
compared exactly.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import ssm as ref_ssm  # noqa: E402
from repro.models.api import build as ref_build  # noqa: E402
from repro.serve.kv_repo import KVRepository as RefKVRepository  # noqa
from repro.serve.session import ServeSession as RefServeSession  # noqa
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import ssm as S  # noqa: E402
from repro_torch.models.api import build  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serve.kv_repo import KVRepository  # noqa: E402
from repro_torch.serve.session import ServeSession  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)
SCAN_TOL = dict(rtol=1e-4, atol=1e-5)
XLSTM, JAMBA = "xlstm-350m", "jamba-1.5-large-398b"
ARCHS = [XLSTM, JAMBA]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(port, ref_out, **tol):
    np.testing.assert_allclose(port.detach().float().numpy(),
                               np.asarray(ref_out, np.float32),
                               **(tol or TOL))


_CACHE = {}


def _once(key, make):
    """``make()``, once per module: the reference's inits and compiles
    dominate this file's time."""
    if key not in _CACHE:
        _CACHE[key] = make()
    return _CACHE[key]


def _both(tree):
    """A port parameter tree as (the reference's jnp tree, the port's
    tree carried back from numpy)."""
    arrays = tree_map(lambda t: t.detach().numpy(), tree)
    return (jax.tree_util.tree_map(jnp.asarray, arrays),
            params_from_numpy(arrays, "cpu"))


def _pair(arch):
    """(ref model, ref params, port model, port params) at the smoke
    config, the same numbers in both packages."""
    def make():
        rm = ref_build(ref_get_config(arch, smoke=True))
        pm = build(get_config(arch, smoke=True), device="cpu")
        rp, pp = _both(pm.init(3))
        return rm, rp, pm, pp
    return _once(arch, make)


def _ref_fns(arch):
    """The reference model's prefill and decode step, jitted once, so
    calls at one shape compile once."""
    rm = _pair(arch)[0]
    return _once(arch + " fns", lambda: (jax.jit(rm.prefill),
                                         jax.jit(rm.decode_step)))


def _cfgs(arch, **overrides):
    rcfg = ref_get_config(arch, smoke=True)
    cfg = get_config(arch, smoke=True)
    return (dataclasses.replace(rcfg, **overrides),
            dataclasses.replace(cfg, **overrides))


def _x(seed, b, s, d):
    return np.random.default_rng(seed).standard_normal(
        (b, s, d)).astype(np.float32)


# ------------------------------------------------------------ Mamba


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_reference(with_state):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    b = rng.standard_normal(12).astype(np.float32)
    st = rng.standard_normal((2, 3, 12)).astype(np.float32) \
        if with_state else None
    want, want_st = ref_ssm._causal_conv(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
        None if st is None else jnp.asarray(st))
    got, got_st = S._causal_conv(_t(x), _t(w), _t(b),
                                 None if st is None else _t(st))
    _close(got, want)
    _close(got_st, want_st)


def _mamba():
    """Jamba's smoke Mamba at a chunk of 8, in both packages."""
    def make():
        rcfg, cfg = (dataclasses.replace(c, ssm=dataclasses.replace(
            c.ssm, chunk=8)) for c in _cfgs(JAMBA))
        gen = torch.Generator().manual_seed(5)
        return (rcfg, cfg, *_both(S.init_mamba(cfg, gen)))
    return _once("mamba", make)


@pytest.mark.parametrize("s,with_state", [(5, False), (24, False),
                                          (24, True), (1, True)],
                         ids=["below_chunk", "three_chunks",
                              "three_chunks_conv_state", "decode"])
def test_mamba_forward_matches_reference(s, with_state):
    """A prefill shorter than the chunk (one chunk of S), of three chunks
    of 8, with a conv state carried in, and a decode step from a state
    (conv state and h): outputs and both parts of the new state."""
    rcfg, cfg, rp, pp = _mamba()
    d = cfg.d_model
    d_in, n = cfg.ssm.expand * d, cfg.ssm.d_state
    rng = np.random.default_rng(s)
    x = _x(s, 2, s, d)
    st = None
    if with_state:
        st = (rng.standard_normal((2, cfg.ssm.d_conv - 1, d_in)).astype(
            np.float32), rng.standard_normal((2, d_in, n)).astype(
                np.float32))
    want, (w_conv, w_h) = ref_ssm.mamba_forward(
        rcfg, rp, jnp.asarray(x),
        None if st is None else tuple(jnp.asarray(a) for a in st))
    got, (g_conv, g_h) = S.mamba_forward(
        cfg, pp, _t(x), None if st is None else tuple(_t(a) for a in st))
    _close(got, want, **SCAN_TOL)
    _close(g_conv, w_conv)
    _close(g_h, w_h, **SCAN_TOL)


def test_mamba_refuses_a_prefill_off_the_chunk():
    """12 tokens over a chunk of 8: the reference asserts, the port
    raises ValueError."""
    rcfg, cfg, rp, pp = _mamba()
    x = _x(0, 1, 12, cfg.d_model)
    with pytest.raises(AssertionError):
        ref_ssm.mamba_forward(rcfg, rp, jnp.asarray(x))
    with pytest.raises(ValueError, match="multiple of the scan's chunk"):
        S.mamba_forward(cfg, pp, _t(x))


def test_affine_scan_equals_the_sequential_recurrence():
    """The doubling scan against h_t = a_t h_{t-1} + b_t step by step,
    at a chunk that is not a power of two."""
    rng = np.random.default_rng(2)
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (2, 13, 3, 4)))
    b = torch.from_numpy(rng.standard_normal((2, 13, 3, 4)))
    acum, hrel = S._affine_scan(a, b)
    h0 = torch.from_numpy(rng.standard_normal((2, 3, 4)))
    h = h0
    for t in range(13):
        h = a[:, t] * h + b[:, t]
        torch.testing.assert_close(acum[:, t] * h0 + hrel[:, t], h,
                                   rtol=1e-12, atol=1e-12)


# ------------------------------------------------------------ xLSTM


def _xlstm_state(kind, cfg, rng, b):
    d = cfg.d_model
    if kind == "mlstm":
        h = cfg.n_heads
        dh = int(cfg.xlstm.proj_factor * d) // h
        return (rng.standard_normal((b, h, dh, dh)),
                rng.standard_normal((b, h, dh)),
                rng.standard_normal((b, h)))
    return (rng.standard_normal((b, d)), rng.uniform(0.5, 2.0, (b, d)),
            rng.standard_normal((b, d)), rng.standard_normal((b, d)))


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
@pytest.mark.parametrize("with_state", [False, True])
def test_xlstm_cell_matches_reference(kind, with_state):
    """``mlstm_forward`` and ``slstm_forward`` (the sLSTM with its FFN)
    over 9 steps, from zeros and from a random state: outputs and every
    leaf of the new state."""
    rcfg, cfg = _cfgs(XLSTM)
    init = {"mlstm": S.init_mlstm, "slstm": S.init_slstm}[kind]
    rp, pp = _once(kind, lambda: _both(init(
        cfg, torch.Generator().manual_seed(7))))
    x = _x(11, 2, 9, cfg.d_model)
    st = None
    if with_state:
        st = tuple(a.astype(np.float32) for a in _xlstm_state(
            kind, cfg, np.random.default_rng(4), 2))
    rf = {"mlstm": ref_ssm.mlstm_forward, "slstm": ref_ssm.slstm_forward}
    pf = {"mlstm": S.mlstm_forward, "slstm": S.slstm_forward}
    want, w_st = rf[kind](rcfg, rp, jnp.asarray(x), None if st is None
                          else tuple(jnp.asarray(a) for a in st))
    got, g_st = pf[kind](cfg, pp, _t(x), None if st is None
                         else tuple(_t(a) for a in st))
    _close(got, want)
    assert len(g_st) == len(w_st)
    for g, w in zip(g_st, w_st):
        assert g.dtype == torch.float32
        _close(g, w)


# ------------------------------------------------------------ models


@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree_and_cache_match_reference(arch):
    """``init_lm``'s keys, shapes and dtypes against the reference's
    ``init_shapes`` (no ``ln2``/``ffn`` in an xLSTM block; Mamba's
    ``A_log`` and ``D`` and the xLSTM gates' weights and biases float32),
    and ``init_cache``'s leaves: the reference's shapes, dtypes and
    values (the recurrent states float32, the sLSTM's m at -10), and no
    two leaves sharing storage."""
    rm, _rp, pm, _ = _pair(arch)
    ref = rm.init_shapes(jax.random.PRNGKey(0))
    port = pm.init(0)
    rl, rdef = jax.tree_util.tree_flatten(ref)
    tl, tdef = jax.tree_util.tree_flatten(port)
    assert str(rdef).replace("PyTreeDef", "") == \
        str(tdef).replace("PyTreeDef", "")
    for a, t in zip(rl, tl):
        assert tuple(a.shape) == tuple(t.shape)
        assert str(a.dtype) == str(t.dtype).replace("torch.", "")
    rc = jax.tree_util.tree_leaves(rm.init_cache(2, 16))
    pc = tree_leaves(pm.init_cache(2, 16))
    assert len(rc) == len(pc)
    for a, t in zip(rc, pc):
        assert tuple(a.shape) == tuple(t.shape)
        assert str(a.dtype) == str(t.dtype).replace("torch.", "")
        np.testing.assert_array_equal(t.numpy(), np.asarray(a))
    ptrs = {t.untyped_storage().data_ptr() for t in pc}
    assert len(ptrs) == len(pc)


def _batch(cfg, toks, s0):
    s = toks.shape[1]
    pos = np.arange(s0, s0 + s, dtype=np.int32)
    return ({"tokens": jnp.asarray(toks), "positions": jnp.asarray(pos)},
            {"tokens": _t(toks).long(), "positions": _t(pos)})


# ------------------------------------------------------------ reuse


def _two_forms(arch):
    """Logits of a cold 40-token prefill and of a 32-token prefill
    followed by an 8-token suffix prefill into the same cache, in each
    package: {form: (ref logits, port logits)}."""
    rm, rp, pm, pp = _pair(arch)
    prefill = _ref_fns(arch)[0]
    toks = np.random.default_rng(9).integers(0, pm.cfg.vocab_size,
                                             (1, 40), dtype=np.int32)
    out = {}
    for form, cuts in (("cold", ((0, 40),)), ("reuse", ((0, 32), (32, 40)))):
        rc, pc = rm.init_cache(1, 40), pm.init_cache(1, 40)
        for s0, s1 in cuts:
            rb, pb = _batch(pm.cfg, toks[:, s0:s1], s0)
            want, rc = prefill(rp, rb, rc, jnp.int32(s0))
            got, pc = pm.prefill(pp, pb, pc, start=s0)
        out[form] = (np.asarray(want), got)
    return out


def test_mamba_suffix_prefill_restarts_the_scan_in_both_packages():
    """A fault of the reference that the port keeps: Mamba's prefill
    starts its scan at h = 0 (``repro/models/ssm.py:124``) and reads
    only the conv state, so a suffix prefill after a reused prefix loses
    the SSM state, and Jamba's logits move by more than 0.1 (largest
    |logit| ~3).  Both packages give the same logits in each form."""
    out = _two_forms(JAMBA)
    for want, got in out.values():
        _close(got, want)
    gap = np.abs(out["cold"][0] - out["reuse"][0]).max()
    port_gap = float((out["cold"][1] - out["reuse"][1]).abs().max())
    assert gap > 0.1, gap
    assert abs(port_gap - gap) <= 1e-4, (port_gap, gap)


def test_xlstm_suffix_prefill_continues_the_state_in_both_packages():
    """The xLSTM cells read their whole state, so a reused prefix plus a
    suffix prefill gives the cold prefill's logits in both packages; in
    the port bit for bit (its projections run in fixed blocks of
    ``ssm.ROWS`` rows, and the prefix is a multiple of them)."""
    out = _two_forms(XLSTM)
    for want, got in out.values():
        _close(got, want)
    assert torch.equal(out["reuse"][1], out["cold"][1])
    np.testing.assert_allclose(out["reuse"][0], out["cold"][0], **TOL)


def test_row_blocks_make_the_xlstm_cells_length_invariant_in_bf16():
    """``_in_row_blocks``: the bf16 cells over 40 steps at once and as
    32 steps then 8 from the carried state give the same bits, outputs
    and states."""
    cfg = get_config(XLSTM, smoke=True).with_(dtype="bfloat16")
    x = _t(_x(12, 1, 40, cfg.d_model)).to(torch.bfloat16)
    for init, fwd in ((S.init_mlstm, S.mlstm_forward),
                      (S.init_slstm, S.slstm_forward)):
        p = init(cfg, torch.Generator().manual_seed(1))
        whole, st = fwd(cfg, p, x)
        head, mid = fwd(cfg, p, x[:, :32])
        tail, st2 = fwd(cfg, p, x[:, 32:], mid)
        assert torch.equal(torch.cat([head, tail], 1), whole)
        assert all(torch.equal(a, b) for a, b in zip(st, st2))


def _conversations(vocab, seed, n_conv=2, first=12, new=4):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, first) for _ in range(n_conv)], \
        [[rng.integers(1, vocab, new) for _ in range(2)]
         for _ in range(n_conv)]


def _chat(serve, firsts, news, n_decode=2):
    """Turn-major multi-turn chat: each later turn is the previous
    prompt, its greedy tokens and new ones.  Returns (tokens per turn,
    (reused, prefilled) per turn)."""
    prompts = [np.asarray(f, np.int32) for f in firsts]
    toks, counts = [], []
    for turn in range(3):
        for c, p in enumerate(prompts):
            out, st = serve(p, n_decode)
            toks.append(np.asarray(out).tolist())
            counts.append((st.reused_tokens, st.prefilled_tokens))
            if turn < 2:
                prompts[c] = np.concatenate([p, out, news[c][turn]]).astype(
                    np.int32)
    return toks, counts


def test_multi_turn_session_matches_reference():
    """xlstm-350m smoke through each package's ``ServeSession`` with a
    ``KVRepository``: 2 conversations of 3 turns, each turn reusing the
    previous turn's prompt state.  The same greedy tokens and the same
    reused and prefilled counts in both packages and in a cold port
    session, and no alias entries (a recurrent state is exact-length)."""
    rm, rp, pm, pp = _pair(XLSTM)
    firsts, news = _conversations(pm.cfg.vocab_size, 8)
    ref_kv, kv = RefKVRepository(), KVRepository()
    ref = RefServeSession(rm, rp, max_len=40, kv=ref_kv)
    port = ServeSession(pm, pp, max_len=40, kv=kv)
    cold = ServeSession(pm, pp, max_len=40)
    want, want_counts = _chat(ref.serve, firsts, news)
    got, got_counts = _chat(port.serve, firsts, news)
    cold_toks, cold_counts = _chat(cold.serve, firsts, news)
    assert got == want == cold_toks
    assert got_counts == want_counts
    assert [r for r, _ in got_counts] == [0, 0, 12, 12, 18, 18]
    assert all(r == 0 for r, _ in cold_counts)
    # six exact-length entries, their bytes (float32 states and logits)
    # counted as the reference counts them
    nbytes = [e.bytes_out for e in kv.repository.entries]
    assert len(nbytes) == 6 and min(nbytes) > 0
    assert nbytes == [e.bytes_out for e in ref_kv.repository.entries]


def test_continuous_batching_gives_serve_tokens():
    """The same turns through ``submit``/``run`` with 4 slots: every
    recurrent leaf of a request's prefill is spliced into its slot, and
    the tokens equal ``serve``'s."""
    _rm, _rp, pm, pp = _pair(XLSTM)
    firsts, news = _conversations(pm.cfg.vocab_size, 10, n_conv=3)
    want, _ = _chat(ServeSession(pm, pp, max_len=40,
                                 kv=KVRepository()).serve, firsts, news)
    sess = ServeSession(pm, pp, n_slots=4, max_len=40, kv=KVRepository())
    prompts = [np.asarray(f, np.int32) for f in firsts]
    got = []
    for turn in range(3):
        tickets = [sess.submit(p, 2) for p in prompts]
        sess.run()
        outs = [t.result() for t in tickets]
        got += [o.tolist() for o in outs]
        if turn < 2:
            prompts = [np.concatenate([p, o, news[c][turn]]).astype(
                np.int32) for c, (p, o) in enumerate(zip(prompts, outs))]
    assert got == want
    assert sess.stats["reused_tokens"] > 0


def test_stored_recurrent_snapshot_survives_later_decodes():
    """The store keeps a copy of a recurrent state: decoding on from the
    spliced snapshot leaves the stored leaves unchanged, and a second
    exact hit returns the stored logits with the same tokens."""
    _rm, _rp, pm, pp = _pair(XLSTM)
    kv = KVRepository()
    sess = ServeSession(pm, pp, max_len=40, kv=kv)
    prompt = np.random.default_rng(3).integers(1, pm.cfg.vocab_size, 16)
    first, _ = sess.serve(prompt, 4)
    name = kv.repository.entries[0].artifact
    stored, _ = kv.store.get(name)
    before = [t.clone() for t in tree_leaves(stored)]
    again, st = sess.serve(prompt, 4)
    assert st.reused_tokens == len(prompt) and st.prefilled_tokens == 0
    assert again.tolist() == first.tolist()
    after = tree_leaves(kv.store.get(name)[0])
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    assert any(float(t.abs().max()) > 0 for t in before)
