"""The xLSTM cells in bf16, the port against the reference on the CPU at
xlstm-350m's smoke config switched to ``dtype="bfloat16"`` in both
packages, the same weights (made by the port's seeded init, carried
across bit for bit) and the same inputs.

The port rounds to bf16 where the reference does:
  * silu (the mLSTM's output gate, the sLSTM block's FFN) is ``x *
    sigmoid(x)``, the sigmoid expanded as the reference's backend expands
    it, each operation rounded, and its gradient by JAX's rules
    (``models/ssm.py::_SiluBF16``);
  * the mLSTM's keys are divided by sqrt(Dh) rounded to bf16 (a JAX weak
    type);
  * the sLSTM's recurrent matrices are cast to float32 inside each step,
    so their gradient is rounded to bf16 a step and added up in bf16, as
    the reference's scan transposes it.

What is left differs in float32: the GEMMs' and the exponentials' last
bits, which the exponential gates amplify (the mLSTM's float32 state
most).  So the tests hold, with these tolerances:
  * silu and its gradient bit for bit over every bf16 value in
    [-16, 16];
  * an sLSTM layer: at least SLSTM_EQUAL of its outputs bit-equal, the
    outputs and every gradient leaf within SLSTM_TOL relative (the norm
    of the difference over the norm);
  * an mLSTM layer: at least MLSTM_EQUAL of its outputs bit-equal (the
    others' float32 state differs in its last bits, and a difference of
    the down projection's cancelling sums reaches 32 bf16 steps of a
    small output), the outputs within MLSTM_OUT and every gradient leaf
    within MLSTM_TOL relative;
  * the whole model (4 layers, 2 x 64 tokens): the loss within LOSS_RTOL,
    the gradient norms within GNORM_RTOL, and the two packages' bf16
    gradients closer to each other than the port's bf16 gradient is to
    its float32 one (the float32 gradient of the same weights, which
    ``tests/test_torch_ssm_models.py`` holds to the reference within
    1e-4): the gap between the packages is below bf16's own error.

With silu rounded once, the divisor unrounded and the recurrent
matrices cast once for all steps, the sLSTM layer's outputs are 62%
bit-equal and its gradients 4e-3 to 7e-3 off, which these bounds
refuse.  At full width (8 layers, d_model 1024) the packages' bf16
gradients have cosine 0.86 with each other and 0.70–0.73 each with the
float32 one: bf16 itself is the gap (ROADMAP queue 3).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
ml_dtypes = pytest.importorskip("ml_dtypes")
jnp = jax.numpy

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import ssm as RS  # noqa: E402
from repro.models.api import build as ref_build  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import ssm as PS  # noqa: E402
from repro_torch.models.api import build  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

XLSTM = "xlstm-350m"
SLSTM_EQUAL, SLSTM_TOL = 0.99, 1e-3
MLSTM_EQUAL, MLSTM_OUT, MLSTM_TOL = 0.90, 2e-3, 6e-3
LOSS_RTOL, GNORM_RTOL = 1e-3, 0.015
BF16 = torch.bfloat16


def _np(t):
    """A port tensor as numpy, bf16 as ml_dtypes' bfloat16 (bit for
    bit)."""
    t = t.detach()
    if t.dtype == BF16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _f64(a):
    if isinstance(a, torch.Tensor):
        return a.detach().double().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32), np.float64)


def _cfgs():
    return (ref_get_config(XLSTM, smoke=True).with_(dtype="bfloat16"),
            get_config(XLSTM, smoke=True).with_(dtype="bfloat16"))


def test_silu_and_its_gradient_bit_equal_to_jax():
    x = torch.arange(-16 * 128, 16 * 128 + 1, dtype=torch.float32) / 128
    x = x.to(BF16)
    ct = torch.randn(x.shape, generator=torch.Generator().manual_seed(0))
    ct = ct.to(BF16)
    want, vjp = jax.vjp(jax.nn.silu, jnp.asarray(_np(x)))
    (want_g,) = vjp(jnp.asarray(_np(ct)))
    xx = x.clone().requires_grad_(True)
    got = PS._silu(xx)
    got.backward(ct)
    assert got.dtype == BF16 and xx.grad.dtype == BF16
    np.testing.assert_array_equal(_f64(got), _f64(want))
    np.testing.assert_array_equal(_f64(xx.grad), _f64(want_g))


def _layer(kind, seq=16):
    """One cell of the bf16 smoke config in both packages: (output, grads
    {name: (ref, port)}) under a seeded cotangent."""
    rcfg, cfg = _cfgs()
    gen = torch.Generator().manual_seed(1)
    p = getattr(PS, f"init_{kind}")(cfg, gen)
    x = torch.randn(2, seq, cfg.d_model, generator=gen).to(BF16)
    ct = torch.randn(2, seq, cfg.d_model, generator=gen).to(BF16)
    arrays = tree_map(_np, p)
    rp = jax.tree_util.tree_map(jnp.asarray, arrays)
    rx, rct = jnp.asarray(_np(x)), jnp.asarray(_np(ct))
    ref_fwd = getattr(RS, f"{kind}_forward")

    def loss(p, x):
        y, _ = ref_fwd(rcfg, p, x)
        return jnp.sum(y.astype(jnp.float32) * rct.astype(jnp.float32)), y

    (_, want), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1),
                                             has_aux=True)(rp, rx)
    pp = params_from_numpy(arrays, "cpu")
    for t in tree_leaves(pp):
        t.requires_grad_(True)
    xx = x.clone().requires_grad_(True)
    got, _ = getattr(PS, f"{kind}_forward")(cfg, pp, xx)
    (got.float() * ct.float()).sum().backward()
    grads = {"x": (gx, xx.grad)}
    for path, g in jax.tree_util.tree_leaves_with_path(gp):
        keys = [k.key for k in path]
        t = pp
        for k in keys:
            t = t[k]
        grads["/".join(keys)] = (g, t.grad)
    return (want, got), grads


def _hold_layer(kind, equal, out_tol, grad_tol):
    (want, got), grads = _layer(kind)
    w, g = _f64(want), _f64(got)
    assert np.mean(w == g) >= equal, (kind, np.mean(w == g))
    assert np.linalg.norm(w - g) <= out_tol * np.linalg.norm(w), kind
    top = max(np.linalg.norm(_f64(r)) for r, _ in grads.values())
    for name, (r, t) in grads.items():
        r, t = _f64(r), _f64(t)
        # a leaf whose gradient is ~0 in exact arithmetic (the sLSTM's
        # input-gate bias) is held against 1e-5 of the largest leaf
        scale = max(np.linalg.norm(r), 1e-5 * top)
        assert np.linalg.norm(r - t) <= grad_tol * scale, \
            (kind, name, np.linalg.norm(r - t) / scale)


def test_slstm_layer_rounds_where_the_reference_does():
    _hold_layer("slstm", SLSTM_EQUAL, SLSTM_TOL, SLSTM_TOL)


def test_mlstm_layer_rounds_where_the_reference_does():
    _hold_layer("mlstm", MLSTM_EQUAL, MLSTM_OUT, MLSTM_TOL)


def test_whole_model_bf16_gradient_gap_is_below_bf16_error():
    rcfg, cfg = _cfgs()
    pm = build(cfg, device="cpu")
    arrays = tree_map(_np, pm.init(3))
    rm = ref_build(rcfg)
    toks = np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 65),
                                             dtype=np.int32)
    pos = np.arange(64, dtype=np.int32)
    rb = {"tokens": jnp.asarray(toks[:, :-1]), "positions": jnp.asarray(pos),
          "labels": jnp.asarray(toks[:, 1:])}
    (_, (r_loss, _)), rg = jax.jit(jax.value_and_grad(
        lambda p: rm.loss_fn(p, rb), has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, arrays))
    ref16 = np.concatenate([_f64(g).ravel()
                            for g in jax.tree_util.tree_leaves(rg)])

    def port(model, tree):
        pb = {"tokens": torch.from_numpy(toks[:, :-1]).long(),
              "positions": torch.from_numpy(pos),
              "labels": torch.from_numpy(toks[:, 1:]).long()}
        params = params_from_numpy(tree, "cpu")
        for t in tree_leaves(params):
            t.requires_grad_(True)
        total, (loss, _) = model.loss_fn(params, pb)
        total.backward()
        return float(loss.detach()), np.concatenate(
            [_f64(t.grad).ravel() for t in tree_leaves(params)])

    loss16, port16 = port(pm, arrays)
    _, port32 = port(build(cfg.with_(dtype="float32"), device="cpu"),
                     tree_map(lambda a: np.asarray(a, np.float32), arrays))
    assert abs(loss16 - float(r_loss)) <= LOSS_RTOL * abs(float(r_loss))
    n_ref, n_port = np.linalg.norm(ref16), np.linalg.norm(port16)
    assert abs(n_port - n_ref) <= GNORM_RTOL * n_ref, (n_ref, n_port)
    between = np.linalg.norm(port16 - ref16) / n_ref
    own = np.linalg.norm(port16 - port32) / np.linalg.norm(port32)
    assert between < own, (between, own)
