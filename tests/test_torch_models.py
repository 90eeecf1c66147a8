"""The port's dense models against the reference's (qwen3-1.7b smoke
config, f32, on the CPU).

Parameters are made by the reference's ``Model.init`` and carried into
the port by ``models/convert.py``, so both packages run the same
numbers.  Forward, prefill (also from a reused ``start``) and decode
(one index for every row, and one per row) must agree within f32
round-off of two differently ordered computations (rtol 2e-5, atol
2e-5 on logits of size ~1).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import ARCH_IDS as REF_ARCH_IDS  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models.api import build as ref_build  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.models import lm as LM  # noqa: E402
from repro_torch.models.api import build  # noqa: E402
from repro_torch.models.convert import (cache_from_numpy,  # noqa: E402
                                        params_from_numpy)

TOL = dict(rtol=2e-5, atol=2e-5)
PORTED = ["qwen3-1.7b", "codeqwen1.5-7b", "yi-6b"]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(port, ref_out, **tol):
    np.testing.assert_allclose(port.detach().float().numpy(),
                               np.asarray(ref_out, np.float32),
                               **(tol or TOL))


@pytest.fixture(scope="module")
def pair():
    """(ref model, ref params, port model, port params) for qwen3-1.7b
    smoke, the port's parameters carried over from the reference's."""
    rm = ref_build(ref_get_config("qwen3-1.7b", smoke=True))
    rp = rm.init(jax.random.PRNGKey(0))
    pm = build(get_config("qwen3-1.7b", smoke=True), device="cpu")
    return rm, rp, pm, params_from_numpy(_np(rp), "cpu")


def _tokens(seed, b, s, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, (b, s),
                                                dtype=np.int32)


# ------------------------------------------------------------ configs


def test_config_registry_equals_reference():
    """Every config, full and smoke, and its superblock layout."""
    from repro.models import lm as ref_lm
    assert ARCH_IDS == REF_ARCH_IDS
    for arch in ARCH_IDS:
        for smoke in (False, True):
            cfg, ref = get_config(arch, smoke), ref_get_config(arch, smoke)
            assert dataclasses.asdict(cfg) == dataclasses.asdict(ref), arch
            assert LM.block_period(cfg) == ref_lm.block_period(ref)
            assert LM.slot_kinds(cfg) == ref_lm.slot_kinds(ref)
            assert LM.n_superblocks(cfg) == ref_lm.n_superblocks(ref)


@pytest.mark.parametrize("arch", [a for a in ARCH_IDS if a not in PORTED])
def test_unported_family_raises_when_built(arch):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build(get_config(arch, smoke=True), device="cpu")


@pytest.mark.parametrize("arch", PORTED)
def test_param_tree_matches_reference(arch):
    """Same keys, shapes and dtypes as the reference's init, with the
    leading superblock axis."""
    ref = _np(ref_build(ref_get_config(arch, smoke=True)).init(
        jax.random.PRNGKey(0)))
    port = build(get_config(arch, smoke=True), device="cpu").init(0)
    ref_leaves, ref_def = jax.tree_util.tree_flatten(ref)
    port_leaves, port_def = jax.tree_util.tree_flatten(port)
    assert str(ref_def).replace("PyTreeDef", "") == \
        str(port_def).replace("PyTreeDef", "")
    for a, t in zip(ref_leaves, port_leaves):
        assert tuple(a.shape) == tuple(t.shape)
        assert str(a.dtype) == str(t.dtype).replace("torch.", "")


@pytest.mark.parametrize("arch", PORTED)
def test_demo_batch_loss_is_finite(arch):
    """The forward half of test_models.py's smoke test, on the port."""
    model = build(get_config(arch, smoke=True), device="cpu")
    total, (loss, aux) = model.loss_fn(model.init(0),
                                       model.demo_batch(0, seq=32, gbs=2))
    assert torch.isfinite(total) and loss.shape == () and float(aux) == 0


def test_bf16_leaves_cross_bit_for_bit():
    a = jnp.asarray(np.random.default_rng(0).standard_normal((5, 7)),
                    jnp.bfloat16)
    t = params_from_numpy({"w": np.asarray(a)}, "cpu")["w"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                  np.asarray(a).view(np.int16))


# ------------------------------------------------------------ forwards


@pytest.mark.parametrize("arch", PORTED)
def test_forward_and_loss_match_reference(arch):
    rm = ref_build(ref_get_config(arch, smoke=True))
    rp = rm.init(jax.random.PRNGKey(1))
    pm = build(get_config(arch, smoke=True), device="cpu")
    pp = params_from_numpy(_np(rp), "cpu")
    toks = _tokens(0, 2, 24)
    labels = _tokens(1, 2, 24)
    pos = np.arange(24, dtype=np.int32)
    want, _ = rm.loss_fn(rp, {"tokens": jnp.asarray(toks),
                              "positions": jnp.asarray(pos),
                              "labels": jnp.asarray(labels)})
    got, (loss, aux) = pm.loss_fn(pp, {"tokens": torch.from_numpy(toks),
                                       "positions": torch.from_numpy(pos),
                                       "labels": torch.from_numpy(labels)})
    _close(got, want)
    from repro.models.lm import lm_forward as ref_forward
    want_logits, _ = ref_forward(rm.cfg, rp, jnp.asarray(toks),
                                 jnp.asarray(pos))
    got_logits, _ = LM.lm_forward(pm.cfg, pp, torch.from_numpy(toks),
                                  torch.from_numpy(pos))
    _close(got_logits, want_logits)


def test_prefill_from_start_matches_reference(pair):
    """A cold prefill of 12 tokens, then the next 8 from start = 12 (the
    prefix-reuse form); logits and the whole cache agree."""
    rm, rp, pm, pp = pair
    toks = _tokens(2, 2, 20)
    rc, pc = rm.init_cache(2, 32), pm.init_cache(2, 32)
    for s0, s1 in ((0, 12), (12, 20)):
        rb = {"tokens": jnp.asarray(toks[:, s0:s1]),
              "positions": jnp.arange(s0, s1, dtype=jnp.int32)}
        pb = {"tokens": torch.from_numpy(toks[:, s0:s1]),
              "positions": torch.arange(s0, s1, dtype=torch.int32)}
        want, rc = rm.prefill(rp, rb, rc, start=jnp.int32(s0))
        got, pc = pm.prefill(pp, pb, pc, start=s0)
        _close(got, want)
    for a, t in zip(jax.tree_util.tree_leaves(rc),
                    jax.tree_util.tree_leaves(pc)):
        _close(t, a)


@pytest.mark.parametrize("per_row", [False, True])
def test_decode_matches_reference(pair, per_row):
    """One decode step from the same cache: the scalar index (every row
    at 12) and the per-row index of continuous batching (rows at 12, 7
    and 0, causality by the per-row kv_len)."""
    rm, rp, pm, pp = pair
    rc = rm.init_cache(3, 24)
    toks = _tokens(3, 3, 12)
    _, rc = rm.prefill(rp, {"tokens": jnp.asarray(toks),
                            "positions": jnp.arange(12, dtype=jnp.int32)},
                       rc)
    pc = cache_from_numpy(_np(rc), "cpu")
    step = _tokens(4, 3, 1)
    if per_row:
        idx = np.array([12, 7, 0], np.int32)
        r_index, p_index = jnp.asarray(idx), torch.from_numpy(idx)
        r_pos, p_pos = jnp.asarray(idx[:, None]), torch.from_numpy(
            idx[:, None])
    else:
        r_index, p_index = jnp.int32(12), 12
        r_pos = jnp.arange(12, 13, dtype=jnp.int32)
        p_pos = torch.arange(12, 13, dtype=torch.int32)
    want, rc2 = rm.decode_step(rp, {"tokens": jnp.asarray(step),
                                    "positions": r_pos}, rc, r_index)
    got, pc2 = pm.decode_step(pp, {"tokens": torch.from_numpy(step),
                                   "positions": p_pos}, pc, p_index)
    _close(got, want)
    _close(pc2["slot0"][0], rc2["slot0"][0])
    _close(pc2["slot0"][1], rc2["slot0"][1])


def test_prefill_decode_matches_full_forward(pair):
    """The port of test_models.py::test_prefill_decode_matches_full_forward
    on the port alone: prefill T tokens, decode K, against lm_forward."""
    _, _, pm, pp = pair
    T, K, B = 12, 3, 2
    toks = torch.from_numpy(_tokens(5, B, T + K))
    pos = torch.arange(T + K, dtype=torch.int32)
    full, _ = LM.lm_forward(pm.cfg, pp, toks, pos)
    cache = pm.init_cache(B, T + K)
    logits, cache = pm.prefill(pp, {"tokens": toks[:, :T],
                                    "positions": pos[:T]}, cache)
    errs = [float((logits[:, -1] - full[:, T - 1]).abs().max())]
    for t in range(K):
        logits, cache = pm.decode_step(
            pp, {"tokens": toks[:, T + t:T + t + 1],
                 "positions": pos[T + t:T + t + 1]}, cache, T + t)
        errs.append(float((logits[:, 0] - full[:, T + t]).abs().max()))
    assert max(errs) < 2e-3, errs
