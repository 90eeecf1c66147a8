"""The training path of the port on the card: the attention backward
kernel (``csrc/flash_attention_bwd.cu``, through ``ops.backward`` and
the ``_Attention`` autograd function) against its plain version,
autograd through ``ref.mha_ref``, over ``bench.backward_cases`` in f32
and bf16 (rows that see no key included); a parameter behind attention
gets a finite, non-zero gradient through it; and a call without a
gradient saves nothing.  The bf16 route (the tensor-core kernels):
its arithmetic against ``ref.mha_bwd_lse_ref`` on every case, the
forward's row statistics against ``ref.mha_lse_ref`` in both of its
forms, two calls bit for bit equal, the routes' launch counters, and
the delta scratch written only inside its (padded) rows.
These tests need a CUDA card and skip without one; this file imports the
port only, so it also runs where JAX is absent.

Tolerances, relative to the largest magnitude of each plain gradient:
1e-4 in f32 (the kernel adds in another order) and 2e-2 in bf16 (both
round the f32 gradient to bf16 once, and the kernel's
``rowsum(dO * O)`` reads the bf16-rounded output).  Against
``mha_bwd_lse_ref``, which rounds P and dS to bf16 where the kernel
does, 1e-2 of the largest entry (the two still round P and dS from
f32 values that differ in their last bits, and sum in other orders).
The row statistics within 1e-3 absolute (exp2/log2 approximations and
another summation order in f32), with the same rows at +inf.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.flash_attention import bench  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    mha_bwd_lse_ref, mha_bwd_ref, mha_lse_ref)
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


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(len(bench.backward_cases())))
def test_sm90_backward_matches_its_arithmetic(cuda, case):
    """The tensor-core route on every case: the plain version of its own
    arithmetic from the forward's lse, and the sm90 counter, not the
    simt one, moves."""
    args, kw = bench.backward_cases()[case]
    q, k, v, do, kw = bench.backward_inputs(cuda, torch.bfloat16, *args, kw)
    out, lse = fa.mha_lse(q, k, v, **kw)
    before = (fa.backward_sm90_launches.count,
              fa.backward_simt_launches.count)
    got = fa.backward(q, k, v, out, do, lse=lse, **kw)
    torch.cuda.synchronize()
    assert (fa.backward_sm90_launches.count,
            fa.backward_simt_launches.count) == (before[0] + 1, before[1])
    want = mha_bwd_lse_ref(q, k, v, out, do, lse, **kw)
    assert _rel_err(got, want) < 1e-2, (args, kw)
    assert _rel_err(got, mha_bwd_ref(q, k, v, do, **kw)) < TOL[
        torch.bfloat16], (args, kw)


@pytest.mark.cuda
@pytest.mark.parametrize("split,shape", [
    (False, (2, 16, 8, 64, 64, dict())),
    (False, (2, 16, 8, 300, 300, dict(q_offset=-20))),   # no-key rows
    (True, (1, 16, 8, 3, 300, dict())),
    (True, (2, 4, 2, 5, 260, dict(kv_len=[0, 200], q_offset=[0, 150]))),
])
def test_forward_lse_matches_plain(cuda, split, shape):
    """The row statistics of the fused form and of the split form (whose
    merge launch writes them)."""
    b, hq, hkv, sq, skv, kw = shape
    q, k, v, _, kw = bench.backward_inputs(cuda, torch.bfloat16, 5, b, hq,
                                           hkv, sq, skv, 128, kw)
    assert fa.plan(q.dtype, "cuda", b, hq, hkv, sq, skv).scratch == split
    before = fa.merge_launches.count
    out, lse = fa.mha_lse(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.merge_launches.count == before + int(split)
    want = mha_lse_ref(q, k, **kw)
    assert torch.equal(torch.isinf(lse), torch.isinf(want))
    fin = torch.isfinite(want)
    assert float((lse[fin] - want[fin]).abs().max()) < 1e-3
    # the output is the serving path's, bit for bit
    assert torch.equal(out, fa.mha(q, k, v, **kw))


@pytest.mark.cuda
def test_sm90_backward_is_deterministic(cuda):
    q, k, v, do, kw = bench.backward_inputs(
        cuda, torch.bfloat16, 6, 2, 16, 8, 300, 300, 128,
        dict(causal=True))
    out, lse = fa.mha_lse(q, k, v, **kw)
    first = fa.backward(q, k, v, out, do, lse=lse, **kw)
    second = fa.backward(q, k, v, out, do, lse=lse, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "sm90"),
                                         (torch.float32, "simt")])
def test_backward_route_counters(cuda, dtype, route):
    """A D = 128 call takes bwd_plan's route: bf16 the tensor cores,
    float32 the CUDA cores; each route counts its own launches."""
    assert fa.bwd_plan(dtype, 128) == route
    q, k, v, do, kw = bench.backward_inputs(cuda, dtype, 7, 2, 16, 8, 64,
                                            64, 128, dict(causal=True))
    ql, kl, vl = (t.clone().requires_grad_(True) for t in (q, k, v))
    counters = (fa.backward_launches, fa.backward_sm90_launches,
                fa.backward_simt_launches)
    before = [c.count for c in counters]
    fa.mha(ql, kl, vl, causal=True).backward(do)
    torch.cuda.synchronize()
    moved = [c.count - n for c, n in zip(counters, before)]
    assert moved == ([1, 1, 0] if route == "sm90" else [1, 0, 1])


@pytest.mark.cuda
@pytest.mark.parametrize("dense", [False, True])
def test_sm90_backward_writes_delta_inside_its_rows(cuda, dense,
                                                    monkeypatch):
    """At an Sq that is not a multiple of 4 (lse rows padded) the dQ
    kernel writes delta only at (b * Hq + h) * ld + pos, pos < Sq: a
    canary scratch, larger than the rows and filled with a sentinel,
    keeps the sentinel everywhere else, for the forward's padded lse and
    for a dense one the wrapper copies."""
    args, kw = bench.backward_cases()[12]           # B=3 Hq=4 Sq=21
    q, k, v, do, kw = bench.backward_inputs(cuda, torch.bfloat16, *args, kw)
    out, lse = fa.mha_lse(q, k, v, **kw)
    if dense:
        lse = lse.contiguous()
    seen = []

    def canary(rows):
        b, hq, sq = rows.shape
        ld = rows.stride(1)
        buf = torch.full((b * hq * ld + 1024,), 1234.5, device=rows.device)
        seen.append(buf)
        return buf[:b * hq * ld].view(b, hq, ld)[..., :sq]
    monkeypatch.setattr(fa, "_delta_rows", canary)
    got = fa.backward(q, k, v, out, do, lse=lse, **kw)
    torch.cuda.synchronize()
    (buf,) = seen
    b, hq, sq = lse.shape
    ld = fa._lse_rows(lse, b, hq, sq, lse.device).stride(1)
    inside = torch.zeros_like(buf, dtype=torch.bool)
    inside[:b * hq * ld].view(b, hq, ld)[..., :sq] = True
    assert bool((buf[~inside] == 1234.5).all())
    assert bool((buf[inside] != 1234.5).all())
    assert _rel_err(got, mha_bwd_ref(q, k, v, do, **kw)) < TOL[
        torch.bfloat16]
