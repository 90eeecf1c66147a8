"""Training the recurrent families (xlstm-350m, jamba-1.5-large-398b) on
the CPU: the chunked remat of the loops over time (``models/ssm.py::
_scan``) against the unchunked loop and against JAX's autodiff of the
reference, and ``launch/train.py`` taking both families.

Tolerances: chunked against unchunked gradients bit-equal (the same
graph, its inputs split and concatenated); against JAX, every gradient
leaf within ``test_torch_ssm_models.py``'s GRAD_TOL of its largest entry
(or GRAD_FLOOR of the largest gradient entry), the loss within its
rtol = atol = 2e-5; AdamW steps' losses within GRAD_TOL of the
reference's, relative (the gradient norms: see LATER_GNORM_TOL).

Run as a script, this file prints, for each of N batches (default 4) of
1 x 80 tokens at xlstm-350m's full width, one superblock (8 layers), in
bfloat16 and in float32, both packages' loss on the batch before and
after one AdamW step at lr 3e-4 on it, and whether the step lowered it:

    PYTHONPATH=src:tests python tests/test_torch_ssm_train.py [N]

With ``XLA_FLAGS=--xla_allow_excess_precision=false`` the reference's
jitted step rounds every bf16 intermediate, as the port's eager
operations do; by default XLA keeps fused elementwise chains in float32.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models.api import build as ref_build  # noqa: E402
from repro.train.optimizer import AdamW as RAdamW  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.train import batch_step, train  # noqa: E402
from repro_torch.models import ssm as S  # noqa: E402
from repro_torch.models.api import build  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.train.optimizer import AdamW  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402
from test_torch_ssm import ARCHS, _batch, _close, _np, _pair, _t  # noqa
from test_torch_ssm_models import GRAD_FLOOR, GRAD_TOL  # noqa: E402


def _grads(cfg, params, batch):
    for p in tree_leaves(params):
        p.requires_grad_(True)
        p.grad = None
    total = build(cfg, device="cpu").loss_fn(params, batch)[0]
    total.backward()
    return total.detach(), [p.grad.clone() for p in tree_leaves(params)]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("seq", [S.REMAT_STEPS + 36, 2 * S.REMAT_STEPS])
def test_chunked_remat_gradients_are_the_unchunked_loops(arch, seq):
    """Under ``cfg.remat`` (chunks of REMAT_STEPS, the last one shorter
    when ``seq`` is not a multiple) every gradient leaf and the loss are
    bit-equal to the loop without remat."""
    cfg = get_config(arch, smoke=True)
    model = build(cfg, device="cpu")
    params = model.init(2)
    batch = model.demo_batch(3, seq, 2)
    want_loss, want = _grads(cfg, params, batch)
    got_loss, got = _grads(cfg.with_(remat=True), params, batch)
    assert torch.equal(got_loss, want_loss)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("arch", ARCHS)
def test_chunked_remat_gradients_match_jax(arch):
    """The loss and every gradient leaf under chunked remat, over more
    steps than one chunk, against JAX's autodiff of the reference's
    loss."""
    rm, rp, pm, _ = _pair(arch)
    cfg = pm.cfg.with_(remat=True)
    toks = np.random.default_rng(8).integers(
        0, cfg.vocab_size, (2, S.REMAT_STEPS + 17), dtype=np.int32)
    rb, pb = _batch(cfg, toks[:, :-1], 0)
    rb["labels"], pb["labels"] = jnp.asarray(toks[:, 1:]), _t(toks[:, 1:])
    (r_tot, _), r_grads = jax.jit(jax.value_and_grad(
        lambda p: rm.loss_fn(p, rb), has_aux=True))(rp)
    params = params_from_numpy(_np(rp), "cpu")
    tot, grads = _grads(cfg, params, pb)
    _close(tot, r_tot)
    r_leaves = jax.tree_util.tree_leaves_with_path(r_grads)
    assert len(r_leaves) == len(grads)
    top = max(float(np.abs(np.asarray(g)).max()) for _, g in r_leaves)
    for (path, rg), g in zip(r_leaves, grads):
        want = np.asarray(rg, np.float64)
        scale = max(float(np.abs(want).max()), GRAD_FLOOR * top)
        err = float(np.abs(g.double().numpy() - want).max())
        assert err <= GRAD_TOL * scale, (jax.tree_util.keystr(path), err)


# AdamW's first update moves each entry by about lr x the sign of its
# gradient, so a last-bit difference in a near-zero gradient entry moves
# that parameter the other way: the gradient norms of later steps differ
# by ~4e-4 relative where the losses still agree within GRAD_TOL
LATER_GNORM_TOL = 1e-3


def _trajectories(rm, pm, params, toks, steps):
    """(loss, gnorm) of each of ``steps`` AdamW steps at lr 3e-4 on one
    repeated batch of ``toks`` ((B, S + 1) int32: tokens and the next
    token as label), from the port's ``params``, in the reference (its
    leaves the same numbers and dtypes) and in the port."""
    rp = jax.tree_util.tree_map(
        lambda t: jnp.asarray(t.detach().float().numpy(),
                              jnp.bfloat16 if t.dtype == torch.bfloat16
                              else jnp.float32), params)
    s = toks.shape[1] - 1
    rb = {"tokens": jnp.asarray(toks[:, :-1]),
          "labels": jnp.asarray(toks[:, 1:]),
          "positions": jnp.arange(s, dtype=jnp.int32)}
    pb = {"tokens": _t(toks[:, :-1]), "labels": _t(toks[:, 1:]),
          "positions": torch.arange(s, dtype=torch.int32)}
    ropt, popt = RAdamW(lr=3e-4), AdamW(lr=3e-4)

    @jax.jit
    def ref_step(p, st):
        (_, (loss, _)), g = jax.value_and_grad(
            lambda q: rm.loss_fn(q, rb), has_aux=True)(p)
        p, st, gnorm = ropt.update(g, st, p)
        return p, st, loss, gnorm

    rs, ps = ropt.init(rp), popt.init(params)
    ref, port = [], []
    for _ in range(steps):
        rp, rs, loss, gnorm = ref_step(rp, rs)
        ref.append((float(loss), float(gnorm)))
        params, ps, loss, gnorm = batch_step(pm, popt, params, ps, pb)
        port.append((float(loss), float(gnorm)))
    return ref, port


def test_adamw_steps_on_a_repeated_batch_match_jax():
    """xlstm-350m's smoke config under chunked remat, 1 + 2 AdamW steps
    on one repeated batch over more steps than one chunk: each step's
    loss within GRAD_TOL of the reference's, the first step's gradient
    norm within GRAD_TOL and the later ones' within LATER_GNORM_TOL, and
    the loss falling in both."""
    cfg = get_config("xlstm-350m", smoke=True).with_(remat=True)
    rm = ref_build(ref_get_config("xlstm-350m", smoke=True))
    pm = build(cfg, device="cpu")
    toks = np.random.default_rng(8).integers(
        0, cfg.vocab_size, (2, S.REMAT_STEPS + 18), dtype=np.int32)
    ref, port = _trajectories(rm, pm, pm.init(0), toks, 3)
    for i, ((r_loss, r_gn), (loss, gn)) in enumerate(zip(ref, port)):
        assert abs(loss - r_loss) <= GRAD_TOL * abs(r_loss), (ref, port)
        tol = GRAD_TOL if i == 0 else LATER_GNORM_TOL
        assert abs(gn - r_gn) <= tol * abs(r_gn), (ref, port)
    for losses in ([r for r, _ in ref], [p for p, _ in port]):
        assert all(b < a for a, b in zip(losses, losses[1:])), (ref, port)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_leaves_prefill_and_decode_alone(arch):
    """A prefill and a decode step record no gradient, so remat runs
    nothing in chunks there: logits and caches bit-equal with and
    without it."""
    cfg = get_config(arch, smoke=True)
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 72))
    outs = []
    for c in (cfg, cfg.with_(remat=True)):
        m = build(c, device="cpu")
        params = m.init(1)
        cache = m.init_cache(2, 80)
        _, pb = _batch(c, toks[:, :71].astype(np.int32), 0)
        logits, cache = m.prefill(params, pb, cache)
        _, db = _batch(c, toks[:, 71:].astype(np.int32), 71)
        step, cache = m.decode_step(params, db, cache, 71)
        outs.append([logits, step] + tree_leaves(cache))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("closed", [False, True])
def test_scan_chunks_a_ragged_tail(closed):
    """``_scan`` with remat over two chunks and a short one, each form
    (``_Chunk``; ``torch.utils.checkpoint`` for a step that closes over a
    weight): the carry, the stacked outputs and every gradient equal the
    loop's, bit for bit."""
    g = torch.Generator().manual_seed(0)
    xs = tuple(torch.randn((3, 2 * S.REMAT_STEPS + 5, 4), generator=g)
               for _ in range(2))
    w0 = torch.randn((4,), generator=g)

    res = []
    for remat in (False, True):
        leaves = [x.clone().requires_grad_(True) for x in xs]
        w = w0.clone().requires_grad_(True)

        def step(carry, a, b):
            (c,) = carry
            c = torch.tanh(c * a + b * (w if closed else 1.0))
            return (c,), c * b
        (c,), hs = S._scan(step, (torch.zeros(3, 4),), leaves, remat,
                           closed=closed)
        (c.sum() + (hs ** 2).sum()).backward()
        res.append([c, hs] + [x.grad for x in leaves]
                   + ([w.grad] if closed else []))
    assert res[0][1].shape == (3, 2 * S.REMAT_STEPS + 5, 4)
    for a, b in zip(*res):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_takes_the_recurrent_families(arch, tmp_path):
    """``launch/train.py::train`` on the CPU: the smoke config from the
    ReStore pipeline, a checkpoint, finite losses."""
    losses = train(arch=arch, steps=2, batch_size=2, seq_len=24,
                   ckpt_every=2, ckpt_dir=str(tmp_path / "ckpt"),
                   data_dir=str(tmp_path / "data"), quiet=True,
                   device="cpu")
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert (tmp_path / "ckpt").exists()


if __name__ == "__main__":
    import dataclasses
    import sys
    n_batches = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    for dtype in ("bfloat16", "float32"):
        cut = dict(n_layers=8, dtype=dtype)
        pm = build(get_config("xlstm-350m").with_(**cut), device="cpu")
        rm = ref_build(dataclasses.replace(ref_get_config("xlstm-350m"),
                                           **cut))
        for seed in range(8, 8 + n_batches):
            toks = np.random.default_rng(seed).integers(
                0, pm.cfg.vocab_size, (1, 81), dtype=np.int32)
            ref, port = _trajectories(rm, pm, pm.init(0), toks, 2)
            (r0, _), (r1, _) = ref
            (p0, _), (p1, _) = port
            print(f"xlstm-350m, 8 layers, {dtype}, batch seed {seed}, 1 x "
                  f"80 tokens, one AdamW step at lr 3e-4: reference "
                  f"{r0:.6f} -> {r1:.6f} ({'lowered' if r1 < r0 else 'raised'}"
                  f"), port {p0:.6f} -> {p1:.6f} "
                  f"({'lowered' if p1 < p0 else 'raised'})", flush=True)
