"""The bf16 attention backward's plain arithmetic against the reference,
on the CPU: the forward's row statistics (``ref.mha_lse_ref``), the
backward computed from them (``ref.mha_bwd_lse_ref``, what
``csrc/flash_attention_bwd.cu`` computes on the tensor cores), and the
routes ``ops.bwd_plan`` gives each dtype and head dim.  Each check runs
at equal head dims and at MLA's (D_qk, D_v) = (96, 64), where dV has v's
64 columns and the scale is 1/sqrt(96).  Inputs are made with numpy from
a seed and handed to both packages.

Tolerances: the row statistics within 1e-5 of JAX's logsumexp (f32, sums
in another order), and the rows that see no key at +inf in both; the
output rebuilt from them within 1e-5 of the reference's attention; the
gradients in f32 within 1e-5 of JAX's autodiff of the reference's
attention (as ``tests/test_torch_train.py`` holds ``mha_bwd_ref``); in
bf16, where P and dS are rounded to bf16 before the products, within
2e-2 of the largest plain gradient (the card's tolerance).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.models.layers import _sdpa as ref_sdpa  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    mha_bwd_lse_ref, mha_bwd_ref, mha_lse_ref, mha_ref)

CASES = [
    dict(hq=4, hkv=2, sq=7, skv=7, causal=True, q_offset=0, kv_len=None),
    dict(hq=4, hkv=4, sq=5, skv=9, causal=False, q_offset=4, kv_len=None),
    dict(hq=8, hkv=2, sq=5, skv=12, causal=True, q_offset=7,
         kv_len=[12, 9]),
    dict(hq=4, hkv=2, sq=6, skv=10, causal=False, q_offset=4,
         kv_len=[0, 10]),
    dict(hq=4, hkv=1, sq=6, skv=10, causal=True, q_offset=-3,
         kv_len=[10, 4]),
]


# (D_qk, D_v): equal head dims, and MLA's (minicpm3-4b)
DIMS = [(16, 16), (96, 64)]


def _inputs(case, seed=3, b=2, d=16, dv=None):
    dv = d if dv is None else dv
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, case["hq"], case["sq"], d)).astype(np.float32)
    k = rng.normal(size=(b, case["hkv"], case["skv"], d)).astype(np.float32)
    v = rng.normal(size=(b, case["hkv"], case["skv"], dv)).astype(np.float32)
    do = rng.normal(size=(b, case["hq"], case["sq"], dv)).astype(np.float32)
    return q, k, v, do


def _kw(case, port=True):
    kv = case["kv_len"]
    if kv is not None:
        kv = torch.tensor(kv) if port else jnp.asarray(kv, jnp.int32)
    return dict(causal=case["causal"], q_offset=case["q_offset"],
                kv_len=kv)


def _ref_scores(q, k, case):
    """The reference attention's masked scores and mask (``_sdpa``)."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    kf = jnp.repeat(jnp.asarray(k), hq // hkv, axis=1)
    s = jnp.einsum("bhqd,bhkd->bhqk", jnp.asarray(q), kf) / d ** 0.5
    k_pos = jnp.arange(skv)[None, None, None, :]
    q_pos = (jnp.arange(sq) + case["q_offset"])[None, None, :, None]
    mask = jnp.ones((1, 1, sq, skv), bool)
    if case["kv_len"] is not None:
        kvl = jnp.asarray(case["kv_len"], jnp.int32).reshape(-1, 1, 1, 1)
        mask = mask & (k_pos < kvl)
    if case["causal"]:
        mask = mask & (k_pos <= q_pos)
    return s, jnp.broadcast_to(mask, s.shape)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("d,dv", DIMS)
def test_mha_lse_ref_matches_jax_logsumexp(case, d, dv):
    q, k, _, _ = _inputs(case, d=d, dv=dv)
    kw = _kw(case)
    got = mha_lse_ref(torch.from_numpy(q), torch.from_numpy(k), **kw)
    s, mask = _ref_scores(q, k, case)
    want = jax.nn.logsumexp(jnp.where(mask, s, -jnp.inf), axis=-1)
    want = np.asarray(jnp.where(mask.any(-1), want, jnp.inf))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_array_equal(np.isinf(got.numpy()), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got.numpy()[fin], want[fin], rtol=1e-5,
                               atol=1e-5)
    # a row sees no key exactly where the statistic is +inf
    assert np.array_equal(np.isinf(want), ~np.asarray(mask.any(-1)))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("d,dv", DIMS)
def test_output_rebuilt_from_lse_matches_reference_attention(case, d, dv):
    """exp(s - lse) over the visible keys, times V, is the reference's
    attention output on every row that sees a key."""
    q, k, v, _ = _inputs(case, d=d, dv=dv)
    lse = mha_lse_ref(torch.from_numpy(q), torch.from_numpy(k),
                      **_kw(case)).numpy()
    s, mask = _ref_scores(q, k, case)
    fin = np.isfinite(lse)
    p = np.where(np.asarray(mask),
                 np.exp(np.asarray(s) - np.where(fin, lse, 0.0)[..., None]),
                 0.0)
    vf = np.repeat(v, q.shape[1] // v.shape[1], axis=1)
    rebuilt = np.einsum("bhqk,bhkd->bhqd", p, vf)
    want = np.asarray(ref_sdpa(q, k, v, **_kw(case, port=False)))
    np.testing.assert_allclose(rebuilt[fin], want[fin], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("d,dv", DIMS)
def test_mha_bwd_lse_ref_matches_reference_autodiff(case, d, dv):
    """The kernel's arithmetic from lse and delta, in f32, and autograd
    through the plain attention (``mha_bwd_ref``), each against JAX's
    gradient of the reference's attention and against each other."""
    q, k, v, do = _inputs(case, d=d, dv=dv)
    rkw = _kw(case, port=False)

    def f(q_, k_, v_):
        return jnp.sum(ref_sdpa(q_, k_, v_, **rkw) * do)
    want = jax.grad(f, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    kw = _kw(case)
    out = mha_ref(tq, tk, tv, **kw)
    lse = mha_lse_ref(tq, tk, **kw)
    got = mha_bwd_lse_ref(tq, tk, tv, out, tdo, lse, **kw)
    assert [tuple(g.shape) for g in got] == [q.shape, k.shape, v.shape]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
    plain = mha_bwd_ref(tq, tk, tv, tdo, **kw)
    for g, p, w in zip(got, plain, want):
        np.testing.assert_allclose(g.numpy(), p.numpy(), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(p.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("d,dv", [(32, 32), (96, 64)])
def test_mha_bwd_lse_ref_in_bf16_within_the_kernels_tolerance(case, d, dv):
    """With bf16 inputs (P and dS rounded to bf16 before the products),
    within 2e-2 of the largest entry of each plain gradient."""
    q, k, v, do = (torch.from_numpy(a).to(torch.bfloat16)
                   for a in _inputs(case, seed=5, d=d, dv=dv))
    kw = _kw(case)
    out = mha_ref(q, k, v, **kw)
    got = mha_bwd_lse_ref(q, k, v, out, do, mha_lse_ref(q, k, **kw), **kw)
    for g, w in zip(got, mha_bwd_ref(q, k, v, do, **kw)):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        err = float((g.float() - w.float()).abs().max())
        assert err <= 2e-2 * max(float(w.float().abs().max()), 1e-30)


def test_rows_without_a_key_get_dv_only():
    """kv_len 0 on one batch row: its dQ is 0, and every key's dV takes
    dO / Skv from it; its lse is +inf."""
    case = dict(hq=2, hkv=1, sq=3, skv=5, causal=False, q_offset=2,
                kv_len=[0, 5])
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(case, seed=9))
    kw = _kw(case)
    lse = mha_lse_ref(q, k, **kw)
    assert torch.isinf(lse[0]).all() and torch.isfinite(lse[1]).all()
    dq, dk, dv = mha_bwd_lse_ref(q, k, v, mha_ref(q, k, v, **kw), do, lse,
                                 **kw)
    assert float(dq[0].abs().max()) == 0.0 and float(dk[0].abs().max()) == 0
    want = do[0].sum(dim=(0, 1)) / 5
    torch.testing.assert_close(dv[0, 0], want.expand(5, -1), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_plan_routes_every_dtype_and_head_dim(dtype, d, device):
    """CPU tensors take the plain version; on the card bf16 takes the
    tensor-core kernels at every head dim and float32 the CUDA-core
    kernel."""
    want = "plain" if device == "cpu" else (
        "sm90" if dtype == torch.bfloat16 else "simt")
    assert fa.bwd_plan(dtype, d, device) == want


def test_bwd_plan_refuses_what_no_route_takes():
    with pytest.raises(ValueError):
        fa.bwd_plan(torch.float16, 128)
    with pytest.raises(ValueError):
        fa.bwd_plan(torch.bfloat16, 96)


@pytest.mark.parametrize("d,dv", [(96, 64), (24, 16), (128, 64)])
def test_bwd_plan_routes_unequal_head_dims_to_the_tensor_cores(d, dv):
    """bf16 takes every (D_qk, D_v) pair the forward takes on the
    tensor-core route and float32 on the CUDA-core route, and a pair the
    forward refuses raises in either dtype."""
    assert fa.bwd_plan(torch.bfloat16, d, "cuda", dv) == "sm90"
    assert fa.bwd_plan(torch.float32, d, "cpu", dv) == "plain"
    assert fa.bwd_plan(torch.float32, d, "cuda", dv) == "simt"
    for dtype in (torch.bfloat16, torch.float32):
        with pytest.raises(ValueError, match="head dim"):
            fa.bwd_plan(dtype, dv, "cuda", d)


def test_backward_takes_mla_head_dims_on_the_cpu():
    """``ops.backward`` at (96, 64) on CPU tensors: dV at v's 64
    columns, equal to the plain version; an ``out`` or ``dout`` at the
    query/key width is refused."""
    case = CASES[2]
    q, k, v, do = (torch.from_numpy(a)
                   for a in _inputs(case, d=96, dv=64))
    kw = _kw(case)
    out = fa.mha(q, k, v, **kw)
    got = fa.backward(q, k, v, out, do, **kw)
    assert [tuple(g.shape) for g in got] == [tuple(q.shape), tuple(k.shape),
                                             tuple(v.shape)]
    assert all(torch.equal(a, b)
               for a, b in zip(got, mha_bwd_ref(q, k, v, do, **kw)))
    with pytest.raises(ValueError, match="do not fit"):
        fa.backward(q, k, v, out, torch.zeros_like(q), **kw)


def test_mha_lse_and_backward_take_the_plain_versions_on_the_cpu():
    case = CASES[2]
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(case))
    kw = _kw(case)
    out, lse = fa.mha_lse(q, k, v, **kw)
    assert torch.equal(out, mha_ref(q, k, v, **kw))
    assert torch.equal(lse, mha_lse_ref(q, k, **kw))
    got = fa.backward(q, k, v, out, do, lse=lse, **kw)
    assert all(torch.equal(a, b)
               for a, b in zip(got, mha_bwd_ref(q, k, v, do, **kw)))


@pytest.mark.parametrize("sq", [1, 3, 4, 37])
def test_lse_rows_are_padded_for_tma(sq):
    """The row statistics' buffer has rows at a multiple of 4 elements
    (16 bytes, TMA's stride unit); an lse laid out otherwise is copied
    into one, and one laid out so is passed as it is."""
    buf = fa._lse_buffer(2, 3, sq, "cpu")
    assert buf.shape == (2, 3, sq) and buf.stride(2) == 1
    assert buf.stride(1) % 4 == 0 and buf.stride(1) >= sq
    assert buf.stride(0) == 3 * buf.stride(1)
    buf.copy_(torch.arange(6 * sq, dtype=torch.float32).view(2, 3, sq))
    assert fa._lse_rows(buf, 2, 3, sq, buf.device) is buf
    dense = buf.contiguous()
    rows = fa._lse_rows(dense, 2, 3, sq, dense.device)
    assert torch.equal(rows, dense) and rows.stride(1) % 4 == 0
    with pytest.raises(ValueError):
        fa._lse_rows(dense[:1], 2, 3, sq, dense.device)


@pytest.mark.parametrize("sq", [1, 3, 4, 21, 37])
@pytest.mark.parametrize("dense", [False, True])
def test_delta_rows_share_the_lse_layout(sq, dense):
    """The backward's delta scratch has lse's strides (the kernels
    address both with lse's row stride) and owns every element that
    stride reaches, whether lse is the forward's padded buffer or a
    dense one ``_lse_rows`` copied."""
    lse = fa._lse_buffer(3, 4, sq, "cpu")
    if dense:
        lse = fa._lse_rows(lse.contiguous(), 3, 4, sq, lse.device)
    delta = fa._delta_rows(lse)
    assert delta.shape == lse.shape and delta.stride() == lse.stride()
    last = (3 * 4 - 1) * lse.stride(1) + sq
    assert delta.untyped_storage().nbytes() >= 4 * last


def test_ptxas_report_is_read_per_kernel(tmp_path, monkeypatch):
    """``build.ptxas_registers`` reads the build's ``ptxas -v`` log of a
    source: each kernel's registers under a readable name, and the lines
    that report a serialized wgmma pipeline."""
    from repro_torch.kernels import build
    monkeypatch.setattr(build, "library", lambda: None)
    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(build, "_digest", lambda: "x")
    (tmp_path / "kernels-x").mkdir()
    ns = "_ZN55_GLOBAL__N__67799fe8_22_flash_attention_bwd_cu_b359422c4"
    (tmp_path / "kernels-x" / "flash_attention_bwd.cu.log").write_text(
        f"ptxas info    : Compiling entry function '{ns}sm9014bwd_dkv_"
        "kernelILi128ELi64EEEv14CUtensorMap_stS2_NS0_6ParamsE' for "
        "'sm_90a'\n    0 bytes stack frame, 0 bytes spill stores\n"
        "ptxas info    : Used 226 registers, used 1 barriers\n"
        f"ptxas info    : Compiling entry function '{ns}simt16bwd_stats_"
        "kernelIfLi32EEEvNS0_4ArgsE' for 'sm_90a'\n"
        "ptxas info    : Used 58 registers, used 1 barriers\n")
    got = build.ptxas_registers("flash_attention_bwd.cu")
    assert got == {"sm90::bwd_dkv_kernel<128, 64>": 226,
                   "simt::bwd_stats_kernel<float, 32>": 58,
                   "serialized": []}
