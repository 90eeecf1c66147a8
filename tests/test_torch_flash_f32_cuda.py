"""The float32 attention kernels on the card at unequal head dims and with
a given row statistic: the forward (``csrc/flash_attention.cu``) and the
CUDA-core backward (``csrc/flash_attention_bwd.cu``, namespace simt) at
MLA's (D_qk, D_v) = (24, 16) (the smoke config) and (96, 64) (minicpm3),
against the plain versions ``ref.mha_ref``, ``ref.mha_lse_ref`` and
``ref.mha_bwd_ref``; the backward given the forward's ``lse`` (which skips
its own statistic) bit for bit equal to the backward that computes it;
and a float32 gradient through chunked attention (``_sdpa_chunked``), each
chunk's backward kernel reading the merged statistic, against autograd
through ``mha_ref``.  These tests need a CUDA card and skip without one;
this file imports the port only, so it also runs where JAX is absent.

Tolerances: outputs within 2e-5 absolute of the plain version (the
reference's attention tests' float32 bound, ``chip_smoke.py``'s FA_TOL),
the statistic within 1e-4 (its LSE_TOL_F32), +inf on exactly the rows
that see no key, and gradients within 1e-4 of the largest plain entry
(its BWD_TOL).
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import ops as fa  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    mha_bwd_ref, mha_lse_ref, mha_ref)
from repro_torch.models import layers as L  # noqa: E402

FA_TOL = 2e-5
LSE_TOL = 1e-4
BWD_TOL = 1e-4
DIMS = [(24, 16), (96, 64)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _qkv(dev, d, dv, b=2, hq=4, hkv=2, sq=70, skv=150, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(s, generator=g, device=dev)
            for s in ((b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, dv))]


def _rel_err(got, want):
    return max(float((g - w).abs().max()) / float(w.abs().max())
               for g, w in zip(got, want))


def _cases(dev):
    i32 = dict(dtype=torch.int32, device=dev)
    return [dict(causal=True, q_offset=None, kv_len=None),
            dict(causal=False, q_offset=0, kv_len=100),
            # per-row lengths and offsets; row 1 sees no key
            dict(causal=True, q_offset=torch.tensor([80, -75], **i32),
                 kv_len=torch.tensor([150, 0], **i32)),
            dict(causal=True, q_offset=3, kv_len=None, sq=1)]


@pytest.mark.cuda
@pytest.mark.parametrize("d,dv", DIMS)
def test_f32_forward_at_unequal_head_dims(cuda, d, dv):
    for kw in _cases(cuda):
        kw = dict(kw)
        q, k, v = _qkv(cuda, d, dv, sq=kw.pop("sq", 70))
        n = fa.launches.count
        out, lse = fa.mha_lse(q, k, v, kw["kv_len"], causal=kw["causal"],
                              q_offset=kw["q_offset"])
        torch.cuda.synchronize()
        assert fa.launches.count == n + 1
        assert fa.plan(q.dtype, "cuda", 2, 4, 2, q.shape[2],
                       150).kernel == "simt"
        want = mha_ref(q, k, v, kw["kv_len"], causal=kw["causal"],
                       q_offset=kw["q_offset"])
        assert out.shape == want.shape
        assert float((out - want).abs().max()) < FA_TOL, kw
        want_lse = mha_lse_ref(q, k, kw["kv_len"], causal=kw["causal"],
                               q_offset=kw["q_offset"])
        inf = torch.isinf(want_lse)
        assert torch.equal(torch.isinf(lse), inf)
        assert float((lse[~inf] - want_lse[~inf]).abs().max()) < LSE_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("d,dv", DIMS)
def test_f32_backward_at_unequal_head_dims(cuda, d, dv):
    for kw in _cases(cuda):
        kw = dict(kw)
        q, k, v = _qkv(cuda, d, dv, sq=kw.pop("sq", 70), seed=1)
        do = torch.randn(q.shape[:3] + (dv,), device=cuda)
        out = fa.mha(q, k, v, **kw)
        n = fa.backward_simt_launches.count
        got = fa.backward(q, k, v, out, do, **kw)
        torch.cuda.synchronize()
        assert fa.backward_simt_launches.count == n + 1
        want = mha_bwd_ref(q, k, v, do, **kw)
        for g, w in zip(got, want):
            assert g.shape == w.shape and torch.isfinite(g).all()
        assert _rel_err(got, want) < BWD_TOL, kw
        # through autograd: the forward saves its lse and the backward
        # reads it
        qkv = [t.detach().requires_grad_(True) for t in (q, k, v)]
        grads = torch.autograd.grad(fa.mha(*qkv, **kw), qkv, do)
        assert _rel_err(grads, want) < BWD_TOL, kw


@pytest.mark.cuda
@pytest.mark.parametrize("d,dv", DIMS + [(64, 64)])
def test_f32_backward_given_lse_equals_its_own(cuda, d, dv):
    """The forward's statistic given to the backward (pass 1 then writes
    delta only) gives the bits of the backward that computes it."""
    q, k, v = _qkv(cuda, d, dv, seed=2)
    do = torch.randn(q.shape[:3] + (dv,), device=cuda)
    out, lse = fa.mha_lse(q, k, v)
    own = fa.backward(q, k, v, out, do)
    given = fa.backward(q, k, v, out, do, lse=lse)
    # a statistic at a dense stride, which the wrapper copies into rows
    # the kernel reads
    dense = fa.backward(q, k, v, out, do, lse=lse.contiguous())
    for a, b, c in zip(own, given, dense):
        assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.cuda
@pytest.mark.parametrize("d,dv", [(64, 64)] + DIMS)
def test_f32_gradient_through_chunked_attention(cuda, d, dv):
    q, k, v = _qkv(cuda, d, dv, b=1, hq=4, hkv=2, sq=512, skv=512, seed=3)
    for kw in (dict(causal=True, q_offset=0),
               dict(causal=False, q_offset=0, kv_len=300)):
        qkv = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out = L._sdpa_chunked(*qkv, chunk=128, **kw)
        do = torch.randn_like(out)
        n = fa.backward_simt_launches.count
        grads = torch.autograd.grad(out, qkv, do)
        torch.cuda.synchronize()
        assert fa.backward_simt_launches.count > n
        want = mha_bwd_ref(q, k, v, do, kw.get("kv_len"),
                           causal=kw["causal"], q_offset=kw["q_offset"])
        assert _rel_err(grads, want) < BWD_TOL, kw
