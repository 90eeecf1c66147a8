"""The training path of the port on the card: the attention backward
kernel (``csrc/flash_attention_bwd.cu``, through ``ops.backward`` and
the ``_Attention`` autograd function) against its plain version,
autograd through ``ref.mha_ref``, over ``bench.backward_cases`` in f32
and bf16 (rows that see no key included); a parameter behind attention
gets a finite, non-zero gradient through it; and a call without a
gradient saves nothing.  These tests need a CUDA card and skip without
one; this file imports the port only, so it also runs where JAX is
absent.

Tolerances, relative to the largest magnitude of each plain gradient:
1e-4 in f32 (the kernel adds in another order) and 2e-2 in bf16 (both
round the f32 gradient to bf16 once, and the kernel's
``rowsum(dO * O)`` reads the bf16-rounded output).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.flash_attention import bench  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa  # noqa: E402
from repro_torch.kernels.flash_attention.ref import mha_bwd_ref  # noqa: E402
from repro_torch.models.api import build  # noqa: E402

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _rel_err(got, want):
    return max(float((g.float() - w.float()).abs().max())
               / max(float(w.float().abs().max()), 1e-30)
               for g, w in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", range(len(bench.backward_cases())))
def test_backward_kernel_matches_plain(cuda, dtype, case):
    args, kw = bench.backward_cases()[case]
    q, k, v, do, kw = bench.backward_inputs(cuda, dtype, *args, kw)
    out = fa.mha(q, k, v, **kw)
    before = fa.backward_launches.count
    got = fa.backward(q, k, v, out, do, **kw)
    torch.cuda.synchronize()
    assert fa.backward_launches.count == before + 1
    want = mha_bwd_ref(q, k, v, do, **kw)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert torch.isfinite(g.float()).all()
    assert _rel_err(got, want) < TOL[dtype], (args, kw)


@pytest.mark.cuda
def test_rows_without_a_key_give_the_plain_gradient(cuda):
    """kv_len = 0 on one row, causal before every key on the other: dQ
    is 0 there, and dV holds dO / Skv over every key."""
    q, k, v, do, kw = bench.backward_inputs(
        cuda, torch.float32, 3, 2, 4, 2, 8, 16, 32,
        dict(kv_len=[0, 16], q_offset=[0, -20]))
    dq, dk, dv = fa.backward(q, k, v, fa.mha(q, k, v, **kw), do, **kw)
    torch.cuda.synchronize()
    assert float(dq.abs().max()) == 0.0 and float(dk.abs().max()) == 0.0
    mean_do = do.sum(2) / 16                        # (B, Hq, D)
    want_dv = mean_do.view(2, 2, 2, 32).sum(2)[:, :, None].expand(
        2, 2, 16, 32)
    assert torch.allclose(dv, want_dv, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_autograd_routes_through_the_backward_kernel(cuda):
    q, k, v, do, kw = bench.backward_inputs(
        cuda, torch.bfloat16, 4, 2, 16, 8, 64, 64, 128, dict(causal=True))
    ql, kl, vl = (t.clone().requires_grad_(True) for t in (q, k, v))
    before = (fa.launches.count, fa.backward_launches.count)
    out = fa.mha(ql, kl, vl, causal=True)
    assert out.grad_fn is not None
    out.backward(do)
    torch.cuda.synchronize()
    assert (fa.launches.count, fa.backward_launches.count) == (
        before[0] + 1, before[1] + 1)
    want = mha_bwd_ref(q, k, v, do, causal=True)
    assert _rel_err((ql.grad, kl.grad, vl.grad), want) < TOL[torch.bfloat16]
    with torch.no_grad():
        assert fa.mha(ql, kl, vl, causal=True).grad_fn is None
    assert fa.mha(q, k, v, causal=True).grad_fn is None    # no input grad
    assert fa.backward_launches.count == before[1] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_parameters_behind_attention_get_a_gradient(cuda, dtype):
    """qwen3-1.7b's smoke config on the card: wq, wk, wv, q_norm and
    k_norm have finite, non-zero gradients, and in f32 every gradient
    leaf agrees with the same step on the CPU."""
    cfg = get_config("qwen3-1.7b", smoke=True).with_(dtype=dtype)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (2, 16))
    grads = {}
    for dev in ("cpu", cuda):
        model = build(cfg, device=dev)
        if dev == "cpu":
            params = host = model.init(seed=0)
        else:
            params = _to(host, dev)
        leaves = _leaves(params)
        for t in leaves.values():
            t.requires_grad_(True)
        batch = {"tokens": torch.tensor(toks, device=dev),
                 "labels": torch.tensor(np.roll(toks, -1, 1), device=dev),
                 "positions": torch.arange(16, dtype=torch.int32,
                                           device=dev)}
        before = fa.backward_launches.count
        total, _ = model.loss_fn(params, batch)
        total.backward()
        if dev != "cpu":
            assert fa.backward_launches.count - before == cfg.n_layers
        grads[str(dev)] = {n: t.grad.float().cpu() for n, t in leaves.items()}
    card = grads[str(cuda)]
    for name in ("wq", "wk", "wv", "q_norm", "k_norm"):
        g = card[f"blocks/slot0/mixer/{name}"]
        assert torch.isfinite(g).all() and float(g.abs().max()) > 0, name
    if dtype == "float32":
        for n, g in card.items():
            w = grads["cpu"][n]
            assert float((g - w).abs().max()) <= 1e-4 * max(
                float(w.abs().max()), 1e-30), n


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _to(tree, dev):
    return {k: _to(v, dev) if isinstance(v, dict) else v.detach().to(dev)
            for k, v in tree.items()}
