"""The encoder-decoder family (seamless-m4t-medium), the port against the
reference on the CPU at the smoke config (f32): the parameter and cache
trees, ``encode``, ``encdec_forward`` and ``Model.loss_fn``, a prefill
followed by decode steps (with both caches after them) at a cross cache
as long as the encoder's output and at one that is not, every gradient
leaf against JAX's autodiff, remat, ``demo_batch``'s keys, and a
``ServeSession`` over the model, which fails at its first request in
both packages (neither session sends the encoder's inputs).

Parameters are made by the reference's ``Model.init`` and carried into
the port by ``models/convert.py``, and inputs are seeded numpy arrays,
so both packages run the same numbers.

Tolerances: the encoder's output, logits, caches and losses within
rtol = atol = 2e-5 (f32 round-off of two differently ordered
computations of values of size ~1, as ``test_torch_models.py``); every
gradient leaf within 1e-4 of its largest entry; remat on and off bit for
bit equal (the same arithmetic recomputed).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import encdec as ref_ed  # noqa: E402
from repro.models.api import build as ref_build  # noqa: E402
from repro.serve.session import ServeSession as RefServeSession  # noqa
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import encdec as ED  # noqa: E402
from repro_torch.models.api import build  # noqa: E402
from repro_torch.models.convert import (cache_from_numpy,  # noqa: E402
                                        params_from_numpy)
from repro_torch.serve.session import ServeSession  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

ARCH = "seamless-m4t-medium"
TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = 1e-4
T_ENC = 12          # encoder positions of the tests' utterances


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(port, ref_out, **tol):
    np.testing.assert_allclose(port.detach().float().numpy(),
                               np.asarray(ref_out, np.float32),
                               **(tol or TOL))


@pytest.fixture(scope="module")
def pair():
    """(ref model, ref params, port model, port params) at the smoke
    config, the port's parameters carried over from the reference's."""
    rm = ref_build(ref_get_config(ARCH, smoke=True))
    rp = rm.init(jax.random.PRNGKey(0))
    pm = build(get_config(ARCH, smoke=True), device="cpu")
    return rm, rp, pm, params_from_numpy(_np(rp), "cpu")


def _batches(cfg, seed, b, s, t=T_ENC):
    """The same batch for both packages: (B, T, d) frame embeddings,
    their positions, decoder tokens (B, S), positions and labels."""
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((b, t, cfg.d_model)).astype(np.float32)
    toks = rng.integers(0, cfg.vocab_size, (b, s + 1), dtype=np.int32)
    arrays = {"enc_embeds": emb,
              "enc_positions": np.arange(t, dtype=np.int32),
              "tokens": toks[:, :-1],
              "positions": np.arange(s, dtype=np.int32),
              "labels": toks[:, 1:]}
    return ({k: jnp.asarray(v) for k, v in arrays.items()},
            {k: torch.from_numpy(np.ascontiguousarray(v))
             for k, v in arrays.items()})


def _tree_spec(tree):
    return [(tuple(t.shape), str(t.dtype).replace("torch.", ""))
            for t in tree_leaves(tree)]


def _ref_spec(tree):
    return [(tuple(a.shape), str(a.dtype))
            for a in jax.tree_util.tree_leaves(tree)]


# ------------------------------------------------------------ trees


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_param_tree_matches_reference(dtype):
    """``init_encdec``'s keys, shapes and dtypes are the reference's."""
    cfg = get_config(ARCH, smoke=True).with_(dtype=dtype)
    port = build(cfg, device="cpu").init(0)
    ref = jax.eval_shape(ref_build(ref_get_config(ARCH, smoke=True).with_(
        dtype=dtype)).init, jax.random.PRNGKey(0))
    assert jax.tree_util.tree_structure(
        jax.tree_util.tree_map(lambda t: 0, port)) == \
        jax.tree_util.tree_structure(jax.tree_util.tree_map(lambda a: 0, ref))
    assert _tree_spec(port) == _ref_spec(ref)
    assert set(port) == {"enc_blocks", "dec_blocks", "embed", "ln_enc",
                         "ln_f", "lm_head"}


@pytest.mark.parametrize("enc_len", [0, 5])
def test_cache_tree_matches_reference(enc_len):
    """``Model.init_cache(batch, max_len, enc_len)``: {"self": (k, v),
    "cross": (k, v)} with the reference's shapes and dtypes (enc_len 0
    gives the cross leaves max_len positions)."""
    cfg = get_config(ARCH, smoke=True).with_(dtype="bfloat16")
    port = build(cfg, device="cpu").init_cache(2, 8, enc_len)
    ref = ref_build(ref_get_config(ARCH, smoke=True).with_(
        dtype="bfloat16")).init_cache(2, 8, enc_len)
    assert set(port) == {"self", "cross"}
    assert _tree_spec(port) == _ref_spec(ref)
    leaves = tree_leaves(port)
    assert len({t.data_ptr() for t in leaves}) == len(leaves)


def test_trees_cross_from_the_reference(pair):
    """``params_from_numpy`` and ``cache_from_numpy`` carry the
    reference's trees across leaf for leaf, bit for bit."""
    rm, rp, pm, pp = pair
    for a, t in zip(jax.tree_util.tree_leaves(rp), tree_leaves(pp)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(a))
    rc = jax.tree_util.tree_map(
        lambda a: jax.random.normal(jax.random.PRNGKey(a.ndim), a.shape),
        rm.init_cache(2, 8, 6))
    pc = cache_from_numpy(_np(rc), "cpu")
    assert set(pc) == {"self", "cross"}
    for a, t in zip(jax.tree_util.tree_leaves(rc), tree_leaves(pc)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(a))


# ------------------------------------------------------------ forward


def test_encode_forward_and_loss_match_reference(pair):
    rm, rp, pm, pp = pair
    cfg = pm.cfg
    rb, pb = _batches(cfg, 1, 2, 10)
    want = ref_ed.encode(rm.cfg, rp, rb["enc_embeds"], rb["enc_positions"])
    got = ED.encode(cfg, pp, pb["enc_embeds"], pb["enc_positions"])
    assert tuple(got.shape) == (2, T_ENC, cfg.d_model)
    _close(got, want)
    want, want_aux = ref_ed.encdec_forward(
        rm.cfg, rp, rb["enc_embeds"], rb["tokens"], rb["enc_positions"],
        rb["positions"])
    got, aux = ED.encdec_forward(cfg, pp, pb["enc_embeds"], pb["tokens"],
                                 pb["enc_positions"], pb["positions"])
    assert got.dtype == torch.float32 and float(aux) == float(want_aux) == 0
    _close(got, want)
    r_tot, (r_loss, r_aux) = rm.loss_fn(rp, rb)
    tot, (loss, aux) = pm.loss_fn(pp, pb)
    for g, w in ((tot, r_tot), (loss, r_loss), (aux, r_aux)):
        _close(g, w)


@pytest.mark.parametrize("enc_len", [T_ENC, 7])
def test_prefill_and_decode_match_reference(pair, enc_len):
    """A 6-token prefill after encoding 12 frames, then 3 decode steps
    (the last with a per-row index): every step's logits, and both
    caches after them.  The cache was made with ``enc_len`` cross
    positions; the prefill returns the encoder's 12 either way, as the
    reference's does."""
    rm, rp, pm, pp = pair
    cfg = pm.cfg
    rb, pb = _batches(cfg, 2, 2, 9)
    toks = pb["tokens"].numpy()
    rc, pc = rm.init_cache(2, 12, enc_len), pm.init_cache(2, 12, enc_len)
    self_leaves = pc["self"]
    pre = {k: v for k, v in rb.items() if k != "labels"}
    pre.update(tokens=rb["tokens"][:, :6], positions=rb["positions"][:6])
    want, rc = rm.prefill(rp, pre, rc)
    pre = {k: v for k, v in pb.items() if k != "labels"}
    pre.update(tokens=pb["tokens"][:, :6], positions=pb["positions"][:6])
    got, pc = pm.prefill(pp, pre, pc)
    _close(got, want)
    assert pc["self"] is self_leaves
    assert _tree_spec(pc) == _ref_spec(rc)
    assert tuple(pc["cross"][0].shape)[3] == T_ENC
    for t in range(6, 9):
        tok = toks[:, t:t + 1]
        want, rc = rm.decode_step(
            rp, {"tokens": jnp.asarray(tok),
                 "positions": jnp.asarray([t], jnp.int32)}, rc, jnp.int32(t))
        idx = t if t < 8 else torch.full((2,), t, dtype=torch.int32)
        got, pc = pm.decode_step(
            pp, {"tokens": torch.from_numpy(np.ascontiguousarray(tok)),
                 "positions": torch.tensor([t], dtype=torch.int32)}, pc, idx)
        _close(got, want)
    for a, t in zip(jax.tree_util.tree_leaves(rc), tree_leaves(pc)):
        _close(t, a)


# ------------------------------------------------------------ training


def test_every_gradient_leaf_matches_jax(pair):
    """``Model.loss_fn``'s gradient, through autograd of the plain
    attention, against JAX's autodiff of the reference's loss."""
    rm, rp, pm, _ = pair
    rb, pb = _batches(pm.cfg, 3, 2, 10)
    r_grads = jax.jit(jax.grad(lambda p: rm.loss_fn(p, rb)[0]))(rp)
    params = params_from_numpy(_np(rp), "cpu")
    for p in tree_leaves(params):
        p.requires_grad_(True)
    pm.loss_fn(params, pb)[0].backward()
    r_leaves = jax.tree_util.tree_leaves_with_path(r_grads)
    t_leaves = tree_leaves(params)
    assert len(r_leaves) == len(t_leaves)
    for (path, rg), tp in zip(r_leaves, t_leaves):
        assert tp.grad is not None, jax.tree_util.keystr(path)
        want = np.asarray(rg, np.float64)
        scale = max(float(np.abs(want).max()), 1e-30)
        err = float(np.abs(tp.grad.double().numpy() - want).max())
        assert err <= GRAD_TOL * scale, (jax.tree_util.keystr(path), err,
                                         scale)


def test_remat_on_and_off_give_the_same_loss_and_gradients(pair):
    """Each encoder and decoder layer recomputed under checkpoint gives
    the same loss and gradients, bit for bit."""
    _, rp, pm, _ = pair
    _, pb = _batches(pm.cfg, 4, 2, 10)
    out = []
    for remat in (False, True):
        model = build(pm.cfg.with_(remat=remat), device="cpu")
        params = params_from_numpy(_np(rp), "cpu")
        for p in tree_leaves(params):
            p.requires_grad_(True)
        total, _ = model.loss_fn(params, pb)
        total.backward()
        out.append((total.detach(), [p.grad for p in tree_leaves(params)]))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


def test_demo_batch_takes_the_encoders_inputs():
    """The reference tests the family before the frontend: the batch is
    enc_embeds, enc_positions, tokens and positions (no ``embeds``,
    though seamless's frontend is "embeds"), and its loss is finite."""
    pm = build(get_config(ARCH, smoke=True), device="cpu")
    assert pm.cfg.frontend == "embeds"
    b = pm.demo_batch(0, seq=8, gbs=2)
    ref = ref_build(ref_get_config(ARCH, smoke=True)).demo_batch(
        jax.random.PRNGKey(0), 8, 2)
    assert set(b) == set(ref) == {"positions", "labels", "enc_embeds",
                                  "enc_positions", "tokens"}
    assert tuple(b["enc_embeds"].shape) == (2, 8, 64)
    total, (loss, _) = pm.loss_fn(pm.init(0), b)
    assert torch.isfinite(total) and float(loss) > 0


# ------------------------------------------------------------ serving


def test_serve_session_fails_at_first_request_in_both_packages(pair):
    """Both sessions prefill with token ids and positions only, and the
    encoder-decoder prefill reads ``enc_embeds``: the first request
    raises KeyError in the reference and in the port alike (ROADMAP
    queue 3)."""
    rm, rp, pm, pp = pair
    prompt = np.arange(1, 9)
    for session in (RefServeSession(rm, rp, max_len=16),
                    ServeSession(pm, pp, max_len=16)):
        with pytest.raises(KeyError, match="enc_embeds"):
            session.serve(prompt, 2)
