"""The port's flash attention against the reference.

On the CPU the port's ``mha`` takes its plain version (``ref.py``); it is
held against the reference's Pallas kernel in interpret mode on the
shapes of ``test_kernel_parity.py::check_mha`` and
``test_kernels.py::test_flash_attention_sweep`` (f32 within 2e-5, bf16
within 3e-2, as those tests), and the serving path's per-row ``kv_len``
and dynamic ``q_offset`` against the reference's ``layers._sdpa``.  The
``cuda`` cases hold the CUDA kernel against the plain version on the
card and skip here.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import ops as fa  # noqa: E402
from repro_torch.kernels.flash_attention.ref import mha_ref  # noqa: E402
from repro_torch.models.convert import tensor_from_numpy  # noqa: E402

F32_TOL, BF16_TOL = 2e-5, 3e-2


@pytest.fixture
def ref():
    """The reference's attention (JAX): the Pallas kernel in interpret
    mode, its bhsd entry point, and the model's ``_sdpa``."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.flash_attention.flash_attention import \
        flash_attention_bhsd
    from repro.kernels.flash_attention.ops import mha
    from repro.models.layers import _sdpa
    return dict(jnp=jnp, mha=mha, bhsd=flash_attention_bhsd, sdpa=_sdpa)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _qkv(seed, b, hq, hkv, sq, skv, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hq, sq, d), np.float32),
            rng.standard_normal((b, hkv, skv, d), np.float32),
            rng.standard_normal((b, hkv, skv, d), np.float32))


def _jax(ref, arrays, dtype):
    return [ref["jnp"].asarray(a, dtype) for a in arrays]


def _port(jax_arrays, device="cpu"):
    """The same values as the reference's arrays (bf16 bit for bit)."""
    return [tensor_from_numpy(np.asarray(a), device) for a in jax_arrays]


def _err(port_out, ref_out):
    return float(np.abs(port_out.float().cpu().numpy()
                        - np.asarray(ref_out, np.float32)).max())


# ------------------------------------------------ CPU: plain vs reference


@pytest.mark.parametrize("seed,sq,skv", [(0, 64, 64), (1, 37, 53),
                                         (2, 64, 128), (3, 1, 64)])
def test_mha_matches_pallas_on_check_mha_shapes(ref, seed, sq, skv):
    qkv = _jax(ref, _qkv(seed, 1, 2, 2, sq, skv, 16), np.float32)
    want = ref["mha"](*qkv, causal=True, impl="pallas", block_q=64,
                      block_k=64, interpret=True)
    assert _err(fa.mha(*_port(qkv), causal=True), want) < F32_TOL


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d", [
    (1, 2, 2, 64, 64, 32),
    (2, 4, 2, 128, 256, 64),
    (1, 8, 1, 64, 128, 128),      # MQA
])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mha_matches_pallas_sweep(ref, b, hq, hkv, sq, skv, d, causal,
                                  dtype):
    jdt = getattr(ref["jnp"], dtype)
    qkv = _jax(ref, _qkv(0, b, hq, hkv, sq, skv, d), jdt)
    want = ref["mha"](*qkv, causal=causal, impl="pallas", block_q=64,
                      block_k=64)
    got = fa.mha(*_port(qkv), causal=causal)
    assert got.dtype == getattr(torch, dtype)
    assert _err(got, want) < (F32_TOL if dtype == "float32" else BF16_TOL)


@pytest.mark.parametrize("kv_len", [1, 100, 256])
def test_decode_with_kv_len_matches_pallas(ref, kv_len):
    qkv = _jax(ref, _qkv(1, 2, 4, 4, 1, 256, 64), np.float32)
    want = ref["mha"](*qkv, kv_len=kv_len, causal=True, impl="pallas",
                      block_q=1, block_k=128, q_offset=kv_len - 1)
    got = fa.mha(*_port(qkv), kv_len=kv_len, causal=True,
                 q_offset=kv_len - 1)
    assert _err(got, want) < F32_TOL


def test_bhsd_matches_pallas(ref):
    q, k, v = (a[:, 0] for a in _qkv(4, 3, 1, 1, 64, 128, 32))
    qkv = _jax(ref, (q, k, v), np.float32)
    for kv_len in (None, 70):
        kw = dict(kv_len=kv_len, causal=True, block_q=64, block_k=64,
                  interpret=True)
        want = ref["bhsd"](*qkv, **kw)
        got = fa.flash_attention_bhsd(*_port(qkv), **kw)
        assert _err(got, want) < F32_TOL


def test_per_row_kv_len_matches_sdpa(ref):
    """Batched decode: one kv_len per row (1 is an idle slot), not
    causal, GQA 4 over 2."""
    qkv = _jax(ref, _qkv(5, 4, 4, 2, 1, 96, 16), np.float32)
    kv_len = np.array([1, 17, 64, 96], np.int32)
    want = ref["sdpa"](*qkv, causal=False, q_offset=0,
                       kv_len=ref["jnp"].asarray(kv_len))
    got = fa.mha(*_port(qkv), torch.from_numpy(kv_len), causal=False,
                 q_offset=0)
    assert _err(got, want) < F32_TOL


@pytest.mark.parametrize("sq,start", [(16, 64), (21, 40), (1, 95)])
def test_dynamic_q_offset_matches_sdpa(ref, sq, start):
    """Prefill from a reused prefix: q_offset = start, kv_len = start +
    Sq over a longer cache, causal, GQA; a (1,) tensor as the model's
    dynamic start."""
    qkv = _jax(ref, _qkv(6, 2, 4, 2, sq, 128, 32), np.float32)
    want = ref["sdpa"](*qkv, causal=True, q_offset=start,
                       kv_len=start + sq)
    got = fa.mha(*_port(qkv), start + sq, causal=True,
                 q_offset=torch.tensor([start], dtype=torch.int32))
    assert _err(got, want) < F32_TOL


def test_per_row_q_offset_matches_sdpa_row_by_row(ref):
    q, k, v = _qkv(7, 3, 4, 2, 8, 80, 16)
    offs = np.array([0, 30, 72], np.int32)
    got = fa.mha(*_port(_jax(ref, (q, k, v), np.float32)),
                 torch.from_numpy(offs + 8), causal=True,
                 q_offset=torch.from_numpy(offs))
    for i, o in enumerate(offs):
        row = _jax(ref, (q[i:i + 1], k[i:i + 1], v[i:i + 1]), np.float32)
        want = ref["sdpa"](*row, causal=True, q_offset=int(o),
                           kv_len=int(o) + 8)
        assert _err(got[i:i + 1], want) < F32_TOL, i


def test_wrapper_rejects_what_the_kernel_does_not_take():
    q, k, v = (torch.from_numpy(a) for a in _qkv(0, 1, 2, 2, 4, 8, 16))
    with pytest.raises(ValueError, match="dtype"):
        fa.mha(q.half(), k.half(), v.half())
    q48, k48, v48 = (torch.from_numpy(a)
                     for a in _qkv(0, 1, 2, 2, 4, 8, 48))
    with pytest.raises(ValueError, match="head dim"):
        fa.mha(q48, k48, v48)
    with pytest.raises(ValueError, match="query heads"):
        fa.mha(torch.cat([q, q[:, :1]], 1), k, v)
    with pytest.raises(ValueError, match="dense"):
        fa.mha(q.transpose(2, 3).contiguous().transpose(2, 3), k, v)


# ------------------------------------------------- card: kernel vs plain


def _card(seed, b, hq, hkv, sq, skv, d, dtype, dev):
    return [torch.from_numpy(a).to(dev, dtype)
            for a in _qkv(seed, b, hq, hkv, sq, skv, d)]


def _kernel_vs_plain(qkv, tol, **kw):
    before = fa.launches.count
    got = fa.mha(*qkv, **kw)
    torch.cuda.synchronize()
    assert fa.launches.count == before + 1
    want = mha_ref(*qkv, **kw)
    err = float((got.float() - want.float()).abs().max())
    assert err < tol, err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal", [
    (1, 2, 2, 64, 64, 16, True), (1, 2, 2, 37, 53, 16, True),
    (1, 2, 2, 64, 128, 16, True), (1, 2, 2, 1, 64, 16, True),
    (1, 2, 2, 64, 64, 32, False), (2, 4, 2, 128, 256, 64, True),
    (1, 8, 1, 64, 128, 128, False), (1, 16, 8, 1040, 1042, 128, True),
])
def test_kernel_matches_plain(cuda, dtype, b, hq, hkv, sq, skv, d, causal):
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    _kernel_vs_plain(_card(0, b, hq, hkv, sq, skv, d, dtype, cuda), tol,
                     causal=causal)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_per_row_kv_len_and_q_offset(cuda, dtype):
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    i32 = dict(dtype=torch.int32, device=cuda)
    # batched decode: per-row kv_len, an idle slot at 1, not causal
    qkv = _card(1, 4, 16, 8, 1, 1042, 128, dtype, cuda)
    _kernel_vs_plain(qkv, tol, causal=False, q_offset=0,
                     kv_len=torch.tensor([1, 1025, 600, 1042], **i32))
    # decode at kv_len = 1..256, one row
    qkv = _card(2, 2, 4, 4, 1, 256, 64, dtype, cuda)
    for kv_len in (1, 100, 256):
        _kernel_vs_plain(qkv, tol, kv_len=kv_len, q_offset=kv_len - 1)
    # warm suffix: 16 rows at q_offset 1024 of a 1042-slot cache
    qkv = _card(3, 1, 16, 8, 16, 1042, 128, dtype, cuda)
    _kernel_vs_plain(qkv, tol, kv_len=1040,
                     q_offset=torch.tensor([1024], **i32))
    # per-row q_offset and kv_len, causal, ragged
    qkv = _card(4, 3, 4, 2, 21, 200, 32, dtype, cuda)
    _kernel_vs_plain(qkv, tol, kv_len=torch.tensor([21, 90, 200], **i32),
                     q_offset=torch.tensor([0, 69, 179], **i32))


@pytest.mark.cuda
def test_kernel_takes_strided_views(cuda):
    """The model's q is a (B, S, H, D) -> (B, H, S, D) view."""
    x = torch.randn(2, 70, 4, 64, device=cuda)
    q = x.transpose(1, 2)
    k = torch.randn(2, 2, 90, 64, device=cuda)
    v = torch.randn(2, 2, 90, 64, device=cuda)
    _kernel_vs_plain((q, k, v), F32_TOL, kv_len=80, q_offset=10)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_is_batch_invariant(cuda, dtype):
    """A query row gets the same bits in a 1040-row prefill, a 16-row
    suffix prefill and a one-row decode."""
    q, k, v = _card(5, 1, 16, 8, 1040, 1042, 128, dtype, cuda)
    full = fa.mha(q, k, v, 1040, causal=True, q_offset=0)
    suffix = fa.mha(q[:, :, 1024:].contiguous(), k, v, 1040, causal=True,
                    q_offset=1024)
    last = fa.mha(q[:, :, 1039:].contiguous(), k, v, 1040, causal=True,
                  q_offset=1039)
    assert torch.equal(full[:, :, 1024:], suffix)
    assert torch.equal(full[:, :, 1039:], last)
