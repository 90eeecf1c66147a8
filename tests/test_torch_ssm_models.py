"""xlstm-350m and jamba-1.5-large-398b as whole models, the port against
the reference on the CPU at the smoke configs (f32): ``lm_forward``'s
logits, a prefill followed by decode steps (with the cache after them),
and ``Model.loss_fn`` with every gradient leaf against JAX's autodiff.
The mixers, caches and serving of these families are held in
``test_torch_ssm.py``, whose helpers this file shares (parameters made
by the port's seeded init, crossing into both packages as numpy
arrays); the two files are apart so that each stays well inside a
worker's share of the run.

Tolerances: logits, caches and losses within rtol = atol = 2e-5 (f32
round-off of two differently ordered computations of values of size
~1); every gradient leaf within 1e-4 of its largest entry, or of 1e-5
of the largest gradient entry where that is larger (GRAD_FLOOR).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.models import lm as ref_lm  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import lm as LM  # noqa: E402
from repro_torch.models.api import build  # noqa: E402
from repro_torch.models.convert import (cache_from_numpy,  # noqa: E402
                                        params_from_numpy)
from repro_torch.tree import tree_leaves  # noqa: E402
from test_torch_ssm import (ARCHS, _batch, _close, _np, _pair,  # noqa
                            _ref_fns, _t)

GRAD_TOL = 1e-4
# a leaf whose gradient is ~0 in exact arithmetic (the sLSTM's input-gate
# bias: the normaliser n cancels the gate's scale, leaving ~4e-10) is
# held against 1e-5 of the largest gradient entry instead of its own
GRAD_FLOOR = 1e-5


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_and_decode_match_reference(arch):
    """``lm_forward`` over 16 tokens; a 32-token prefill into a cache and
    4 decode steps (one index for every row, then one per row): every
    step's logits and, after them, every cache leaf."""
    rm, rp, pm, pp = _pair(arch)
    prefill, dec = _ref_fns(arch)
    cfg = pm.cfg
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 36),
                                             dtype=np.int32)
    rb, pb = _batch(cfg, toks[:, :16], 0)
    want, _ = ref_lm.lm_forward(rm.cfg, rp, rb["tokens"], rb["positions"])
    got, _ = LM.lm_forward(cfg, pp, pb["tokens"], pb["positions"])
    _close(got, want)
    rc, pc = rm.init_cache(1, 40), pm.init_cache(1, 40)
    rb, pb = _batch(cfg, toks[:, :32], 0)
    want, rc = prefill(rp, rb, rc, jnp.int32(0))
    got, pc2 = pm.prefill(pp, pb, pc)
    assert pc2 is pc
    _close(got, want)
    for t in range(32, 36):
        rb, pb = _batch(cfg, toks[:, t:t + 1], t)
        idx = t if t < 34 else torch.full((1,), t, dtype=torch.int32)
        want, rc = dec(rp, rb, rc, jnp.int32(t))
        got, pc = pm.decode_step(pp, pb, pc, idx)
        _close(got, want)
    for a, t in zip(jax.tree_util.tree_leaves(rc), tree_leaves(pc)):
        _close(t, a)
    # the port's cache carried back through convert equals the reference's
    for a, t in zip(jax.tree_util.tree_leaves(rc),
                    tree_leaves(cache_from_numpy(_np(rc), "cpu"))):
        np.testing.assert_array_equal(t.numpy(), np.asarray(a))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_leaf_match_jax(arch):
    """``Model.loss_fn`` (total, loss, aux) and, through autograd of the
    plain loops, every parameter's gradient against JAX's autodiff of the
    reference's loss."""
    rm, rp, pm, _ = _pair(arch)
    cfg = pm.cfg
    rng = np.random.default_rng(6)
    toks = rng.integers(0, cfg.vocab_size, (2, 17), dtype=np.int32)
    rb, pb = _batch(cfg, toks[:, :-1], 0)
    rb["labels"], pb["labels"] = jnp.asarray(toks[:, 1:]), _t(toks[:, 1:])
    (r_tot, (r_loss, r_aux)), r_grads = jax.jit(jax.value_and_grad(
        lambda p: rm.loss_fn(p, rb), has_aux=True))(rp)
    params = params_from_numpy(_np(rp), "cpu")
    for p in tree_leaves(params):
        p.requires_grad_(True)
    tot, (loss, aux) = pm.loss_fn(params, pb)
    tot.backward()
    for g, w in ((tot, r_tot), (loss, r_loss), (aux, r_aux)):
        _close(g, w)
    r_leaves = jax.tree_util.tree_leaves_with_path(r_grads)
    t_leaves = tree_leaves(params)
    assert len(r_leaves) == len(t_leaves)
    top = max(float(np.abs(np.asarray(rg)).max()) for _, rg in r_leaves)
    for (path, rg), tp in zip(r_leaves, t_leaves):
        assert tp.grad is not None, jax.tree_util.keystr(path)
        want = np.asarray(rg, np.float64)
        scale = max(float(np.abs(want).max()), GRAD_FLOOR * top)
        err = float(np.abs(tp.grad.double().numpy() - want).max())
        assert err <= GRAD_TOL * scale, (jax.tree_util.keystr(path), err,
                                         scale)


@pytest.mark.parametrize("arch", ARCHS)
def test_demo_batch_loss_is_finite(arch):
    pm = build(get_config(arch, smoke=True), device="cpu")
    total, (loss, aux) = pm.loss_fn(pm.init(0), pm.demo_batch(0, 16, 2))
    assert torch.isfinite(total) and float(loss) > 0
