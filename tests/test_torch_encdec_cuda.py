"""The encoder-decoder family's attention and MLA's attention backward on
the card.  The bf16 kernels (``csrc/flash_attention_sm90.cu`` forward,
``csrc/flash_attention_bwd.cu`` backward) at seamless-m4t's shapes, 16
heads x 64: the encoder's non-causal self-attention, the decoder's
cross-attention (non-causal, Sq != Skv, a prefill and a decode row) and
its causal self-attention, against ``ref.mha_ref`` and the plain
gradients; the backward at MLA's (D_qk, D_v) = (96, 64) against
``ref.mha_bwd_lse_ref`` with its route counter, dQ and dV written in
their 96 and 64 columns only (sentinel-filled outputs keep the sentinel
everywhere past them); and seamless-m4t-medium's smoke config on the
card against the CPU, served and trained.
These tests need a CUDA card and skip without one; this file imports the
port only, so it also runs where JAX is absent.

Tolerances: the forward within 3e-2 absolute of the plain version in
bf16 and each row's error within 0.06 of its RMS (``chip_smoke.py``'s
FA_TOL and FA_REL_TOL); gradients within 2e-2 of each plain gradient's
largest entry, and within 1e-2 of ``mha_bwd_lse_ref``'s (which rounds P
and dS to bf16 where the kernel does), the forward's row statistics
within 1e-3 (``tests/test_torch_train_cuda.py``'s tolerances).  The
smoke model card against CPU: logits within 1e-4 in f32 (another
summation order in the GEMMs), every gradient leaf within 1e-4 of its
largest entry.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    mha_bwd_lse_ref, mha_bwd_ref, mha_lse_ref, mha_ref)
from repro_torch.models.api import build  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

FA_TOL, FA_REL_TOL = 3e-2, 0.06
BWD_TOL, BWD_OWN_TOL, LSE_TOL = 2e-2, 1e-2, 1e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _rel_err(got, want):
    return max(float((g.float() - w.float()).abs().max())
               / max(float(w.float().abs().max()), 1e-30)
               for g, w in zip(got, want))


def _inputs(dev, seed, b, hq, hkv, sq, skv, d, dv):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(s, generator=g, device=dev).to(torch.bfloat16)
            for s in ((b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, dv),
                      (b, hq, sq, dv))]


# (label, B, Sq, Skv, causal): seamless's attention calls at a smaller
# batch and length, 16 heads x 64
ENCDEC_CASES = [
    ("encoder self", 2, 200, 200, False),
    ("cross prefill", 2, 16, 200, False),
    ("cross decode", 2, 1, 200, False),
    ("decoder self", 2, 16, 16, True),
    ("cross, ragged", 3, 37, 129, False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ENCDEC_CASES, ids=lambda c: c[0])
def test_forward_and_backward_at_encdec_shapes(cuda, case):
    _, b, sq, skv, causal = case
    q, k, v, do = _inputs(cuda, sq + skv, b, 16, 16, sq, skv, 64, 64)
    got = fa.mha(q, k, v, causal=causal)
    want = mha_ref(q, k, v, causal=causal)
    diff = (got.float() - want.float()).abs()
    assert float(diff.max()) < FA_TOL
    rms = want.float().pow(2).mean(-1).sqrt()
    assert float((diff.amax(-1) / rms).max()) < FA_REL_TOL
    out, lse = fa.mha_lse(q, k, v, causal=causal)
    want_lse = mha_lse_ref(q, k, causal=causal)
    assert float((lse - want_lse).abs().max()) < LSE_TOL
    before = fa.backward_sm90_launches.count
    grads = fa.backward(q, k, v, out, do, causal=causal, lse=lse)
    torch.cuda.synchronize()
    assert fa.backward_sm90_launches.count == before + 1
    want = mha_bwd_ref(q, k, v, do, causal=causal)
    assert _rel_err(grads, want) < BWD_TOL
    assert _rel_err(grads, mha_bwd_lse_ref(q, k, v, out, do, lse,
                                           causal=causal)) < BWD_OWN_TOL


# (seed, B, Hq, Hkv, Sq, Skv, kwargs) at (D_qk, D_v) = (96, 64): a causal
# training call at minicpm3's 40 heads over several tiles, GQA, ragged
# non-causal, per-row kv_len and q_offset, and rows that see no key
MLA_CASES = [
    (1, 1, 40, 40, 300, 300, dict(causal=True)),
    (2, 2, 8, 2, 130, 130, dict(causal=True)),
    (3, 2, 4, 4, 37, 53, dict(causal=False)),
    (4, 3, 4, 2, 21, 200, dict(kv_len=[21, 90, 200], q_offset=[0, 69, 179])),
    (5, 2, 16, 8, 40, 100, dict(kv_len=[0, 100], q_offset=[5, -3])),
]


def _mla(dev, case):
    seed, b, hq, hkv, sq, skv, kw = case
    q, k, v, do = _inputs(dev, seed, b, hq, hkv, sq, skv, 96, 64)
    kw = {n: torch.tensor(x, dtype=torch.int32, device=dev)
          if isinstance(x, list) else x for n, x in kw.items()}
    return q, k, v, do, kw


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(len(MLA_CASES)))
def test_backward_at_mla_head_dims(cuda, case):
    """The tensor-core route at (96, 64): its own arithmetic from the
    forward's lse, the plain gradients, and the sm90 counter (not the
    simt one) moves; through autograd, too."""
    q, k, v, do, kw = _mla(cuda, MLA_CASES[case])
    assert fa.bwd_plan(q.dtype, 96, "cuda", 64) == "sm90"
    out, lse = fa.mha_lse(q, k, v, **kw)
    before = (fa.backward_sm90_launches.count,
              fa.backward_simt_launches.count)
    got = fa.backward(q, k, v, out, do, lse=lse, **kw)
    torch.cuda.synchronize()
    assert (fa.backward_sm90_launches.count,
            fa.backward_simt_launches.count) == (before[0] + 1, before[1])
    assert [tuple(g.shape) for g in got] == [tuple(q.shape), tuple(k.shape),
                                             tuple(v.shape)]
    assert _rel_err(got, mha_bwd_lse_ref(q, k, v, out, do, lse, **kw)) \
        < BWD_OWN_TOL
    assert _rel_err(got, mha_bwd_ref(q, k, v, do, **kw)) < BWD_TOL
    ql, kl, vl = (t.clone().requires_grad_(True) for t in (q, k, v))
    fa.mha(ql, kl, vl, **kw).backward(do)
    torch.cuda.synchronize()
    assert fa.backward_sm90_launches.count == before[0] + 2
    assert all(torch.equal(a, b)
               for a, b in zip((ql.grad, kl.grad, vl.grad), got))


class _Canary:
    """``torch`` for ``ops``, except that each 4-d bf16 ``empty`` (the
    backward's dQ, dK and dV) is the head of a larger buffer filled with
    a sentinel."""
    SENTINEL = 12288.0        # exact in bf16; no gradient here reaches it

    def __init__(self):
        self.bufs = []

    def __getattr__(self, name):
        return getattr(torch, name)

    def empty(self, shape, dtype=None, device=None):
        if dtype != torch.bfloat16 or len(shape) != 4:
            return torch.empty(shape, dtype=dtype, device=device)
        n = math.prod(shape)
        buf = torch.full((n + 128 * shape[-2],), self.SENTINEL, dtype=dtype,
                         device=device)
        self.bufs.append((buf, n))
        return buf[:n].view(shape)


@pytest.mark.cuda
def test_mla_backward_writes_its_columns_only(cuda, monkeypatch):
    """dQ (96 columns), dK (96) and dV (64) are written whole and nowhere
    past them: a padded column written at the kernels' 128-column width,
    or dV at the query/key row stride, would reach the sentinel tail."""
    q, k, v, do, kw = _mla(cuda, MLA_CASES[1])
    out, lse = fa.mha_lse(q, k, v, **kw)
    canary = _Canary()
    monkeypatch.setattr(fa, "torch", canary)
    got = fa.backward(q, k, v, out, do, lse=lse, **kw)
    torch.cuda.synchronize()
    assert len(canary.bufs) == 3
    for buf, n in canary.bufs:
        assert bool((buf[n:] == _Canary.SENTINEL).all())
        assert bool((buf[:n] != _Canary.SENTINEL).all())
    assert _rel_err(got, mha_bwd_ref(q, k, v, do, **kw)) < BWD_TOL


def _batch(cfg, dev, b=2, t=24, s=12, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s + 1))
    return {"enc_embeds": torch.from_numpy(rng.standard_normal(
                (b, t, cfg.d_model)).astype(np.float32)).to(dev),
            "enc_positions": torch.arange(t, dtype=torch.int32, device=dev),
            "tokens": torch.from_numpy(toks[:, :-1]).to(dev),
            "positions": torch.arange(s, dtype=torch.int32, device=dev),
            "labels": torch.from_numpy(toks[:, 1:]).to(dev)}


@pytest.mark.cuda
def test_seamless_smoke_model_on_the_card(cuda):
    """The smoke config (f32, 4 heads x 16: the CUDA-core kernels) on the
    card against the CPU: a prefill and 3 decode steps, the cross cache
    the prefill returns, and every gradient leaf of ``loss_fn``, with
    the forward and backward kernels launched."""
    cfg = get_config("seamless-m4t-medium", smoke=True)
    cpu, card = build(cfg, device="cpu"), build(cfg, device=cuda)
    p_cpu = cpu.init(0)
    p_card = tree_map(lambda t: t.to(cuda), p_cpu)
    counts = (fa.launches.count, fa.backward_launches.count)
    logits, grads, caches = [], [], []
    for m, p, dev in ((cpu, p_cpu, "cpu"), (card, p_card, cuda)):
        batch = _batch(cfg, dev)
        cache = m.init_cache(2, 16, 8)
        pre = {k: v[:, :8] if k == "tokens" else v[:8] if k == "positions"
               else v for k, v in batch.items() if k != "labels"}
        first, cache = m.prefill(p, pre, cache)
        steps = [first]
        for t in range(8, 11):
            nxt, cache = m.decode_step(
                p, {"tokens": batch["tokens"][:, t:t + 1],
                    "positions": batch["positions"][t:t + 1]}, cache, t)
            steps.append(nxt)
        logits.append(torch.cat(steps, 1).float().cpu())
        caches.append([c.float().cpu() for c in tree_leaves(cache)])
        leaves = tree_leaves(p)
        for t in leaves:
            t.requires_grad_(True)
        m.loss_fn(p, batch)[0].backward()
        grads.append([t.grad.float().cpu() for t in leaves])
        for t in leaves:
            t.grad = None
            t.requires_grad_(False)
    torch.cuda.synchronize()
    assert fa.launches.count > counts[0]
    assert fa.backward_launches.count > counts[1]
    assert float((logits[0] - logits[1]).abs().max()) <= 1e-4
    assert [tuple(c.shape) for c in caches[1]] == \
        [tuple(c.shape) for c in caches[0]]
    assert tuple(caches[1][0].shape)[3] == 24        # the encoder's length
    for a, b in zip(*caches):
        assert float((a - b).abs().max()) <= 1e-4
    for a, b in zip(*grads):
        assert float((a - b).abs().max()) <= 1e-4 * max(
            float(a.abs().max()), 1e-30)
