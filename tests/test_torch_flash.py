"""The port's flash attention against the reference.

On the CPU the port's ``mha`` takes its plain version (``ref.py``); it is
held against the reference's Pallas kernel in interpret mode on the
shapes of ``test_kernel_parity.py::check_mha`` and
``test_kernels.py::test_flash_attention_sweep`` (f32 within 2e-5, bf16
within 3e-2, as those tests), and the serving path's per-row ``kv_len``
and dynamic ``q_offset`` against the reference's ``layers._sdpa``.  The
bf16 kernel's split-KV arithmetic (``ref.mha_split_ref``: fixed 128-key
splits, each its own online softmax, merged in key order) is held
against the Pallas kernel and the plain version at the split boundaries,
and the wrapper's dispatch (``ops.plan``) is checked in pure Python.
The ``cuda`` cases hold the CUDA kernels (bf16 on the tensor cores, f32
on the CUDA cores) against the plain version on the card and skip here.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import ops as fa  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    mha_ref, mha_split_ref)
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


# ------------------------------- CPU: the bf16 kernel's split-KV arithmetic


@pytest.mark.parametrize("seed,sq,skv", [(0, 64, 64), (1, 37, 53),
                                         (2, 64, 128), (3, 1, 64)])
def test_split_ref_matches_pallas_and_plain_on_check_mha_shapes(
        ref, seed, sq, skv):
    qkv = _jax(ref, _qkv(seed, 1, 2, 2, sq, skv, 16), np.float32)
    want = ref["mha"](*qkv, causal=True, impl="pallas", block_q=64,
                      block_k=64, interpret=True)
    port = _port(qkv)
    got = mha_split_ref(*port, causal=True)
    assert _err(got, want) < F32_TOL
    assert _err(got, mha_ref(*port, causal=True).numpy()) < F32_TOL


# split boundaries (128 keys) and +-1, kv_len 1; one decode row each
@pytest.mark.parametrize("kv_len", [1, 127, 128, 129, 255, 256, 257])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_ref_at_split_boundaries_matches_pallas(ref, kv_len, dtype):
    jdt = getattr(ref["jnp"], dtype)
    qkv = _jax(ref, _qkv(8, 2, 4, 2, 1, 384, 32), jdt)
    want = ref["mha"](*qkv, kv_len=kv_len, causal=True, impl="pallas",
                      block_q=1, block_k=128, q_offset=kv_len - 1)
    port = _port(qkv)
    got = mha_split_ref(*port, kv_len=kv_len, causal=True,
                        q_offset=kv_len - 1)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    assert _err(got, want) < tol
    plain = mha_ref(*port, kv_len=kv_len, causal=True, q_offset=kv_len - 1)
    assert _err(got, plain.float().numpy()) < tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_split_ref_per_row_boundaries_match_plain(dtype, causal):
    """Per-row kv_len and q_offset at, and one off, the split boundaries,
    causal prefill rows and non-causal decode rows, GQA 4 over 2."""
    kv_len = torch.tensor([127, 128, 129, 255, 256, 257], dtype=torch.int32)
    sq = 9 if causal else 1
    q, k, v = (torch.from_numpy(a).to(dtype)
               for a in _qkv(9, 6, 4, 2, sq, 300, 32))
    kw = dict(kv_len=kv_len, causal=causal,
              q_offset=kv_len - sq if causal else 0)
    got = mha_split_ref(q, k, v, **kw).float()
    want = mha_ref(q, k, v, **kw).float()
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    assert float((got - want).abs().max()) < tol


def test_split_ref_kv_len_zero_returns_zero_and_one_returns_v0():
    """kv_len 0 gives the mean of V over all Skv keys (it gave 0 before
    the no-key rows were repaired, hence the name), kv_len 1 gives V's
    first key; both as ``mha_ref`` gives them."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(10, 2, 2, 1, 1, 200, 16))
    kw = dict(kv_len=torch.tensor([0, 1]), causal=False, q_offset=0)
    out = mha_split_ref(q, k, v, **kw)
    assert float((out - mha_ref(q, k, v, **kw)).abs().max()) < F32_TOL
    assert float((out[0] - v[0].mean(1, keepdim=True)).abs().max()) \
        < F32_TOL
    assert float((out[1] - v[1, :, :1]).abs().max()) < F32_TOL


def test_rows_without_a_visible_key_pinned(ref):
    """A row that sees no key: the reference's Pallas kernel returns the
    mean of V at kv_len 0 and 0 for a causal row before every key (its
    causal tile skip, which depends on its block_q, so no target for the
    port); the plain version and the kernels' split arithmetic return the
    mean of V in both cases, as the reference's attention_ref and model
    do.  No model call makes such a row."""
    q, k, v = _qkv(15, 1, 1, 1, 1, 64, 16)
    qkv = _jax(ref, (q[:, 0], k[:, 0], v[:, 0]), np.float32)
    mean_v = v[0, 0].mean(0)
    for kw, ref_out in [(dict(kv_len=0, causal=False, q_offset=0), mean_v),
                        (dict(kv_len=64, causal=True, q_offset=-1), 0.0)]:
        want = ref["bhsd"](*qkv, block_q=1, block_k=64, interpret=True,
                           **kw)
        assert np.abs(np.asarray(want)[0, 0] - ref_out).max() < F32_TOL
        t = [torch.from_numpy(a) for a in (q, k, v)]
        plain = mha_ref(*t, **kw)
        assert np.abs(plain[0, 0, 0].numpy() - mean_v).max() < F32_TOL
        assert float((mha_split_ref(*t, **kw) - plain).abs().max()) \
            < F32_TOL


def test_plan_routes_by_dtype_and_splits_by_keys_only():
    assert fa.plan(torch.bfloat16, "cpu", 1, 16, 8, 1, 1042).kernel == \
        "plain"
    assert fa.plan(torch.float32, "cuda", 1, 16, 8, 1, 1042).kernel == \
        "simt"
    splits = set()
    for b in (1, 4, 64):
        for sq in (1, 16, 1040):
            p = fa.plan(torch.bfloat16, "cuda", b, 16, 8, sq, 1042)
            assert p.kernel == "sm90"
            splits.add(p.n_splits)
    assert splits == {-(-1042 // fa.SPLIT_KEYS)}
    for skv in (1, 128, 129, 1042):
        assert fa.plan(torch.bfloat16, "cuda", 1, 16, 8, 1, skv).n_splits \
            == -(-skv // fa.SPLIT_KEYS)
    # the split form where the fused one would leave SMs idle
    assert fa.plan(torch.bfloat16, "cuda", 1, 16, 8, 1, 1042).scratch
    assert fa.plan(torch.bfloat16, "cuda", 4, 16, 8, 1, 1042).scratch
    assert not fa.plan(torch.bfloat16, "cuda", 1, 16, 8, 1040, 1042).scratch
    assert not fa.plan(torch.bfloat16, "cuda", 1, 16, 8, 1, 128).scratch


def test_row_args_go_by_value_or_as_device_arrays():
    assert fa._row_arg(None, 3, 7, "cpu")[1:] == (None, 7)
    assert fa._row_arg(5, 3, 7, "cpu")[1:] == (None, 5)
    t, ptr, _ = fa._row_arg(torch.tensor([4]), 3, 7, "cpu")
    assert t.tolist() == [4, 4, 4] and t.dtype == torch.int32
    assert ptr == t.data_ptr()
    with pytest.raises(ValueError, match="int32"):
        fa._row_arg(2**31, 3, 7, "cpu")


def test_wrapper_rejects_wide_gqa_groups_in_bf16():
    q = torch.zeros(1, 128, 1, 16, dtype=torch.bfloat16)
    kv = torch.zeros(1, 1, 8, 16, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="per KV head"):
        fa.mha(q, kv, kv)


# ------------------------------------- card: the bf16 tensor-core kernel


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_sm90_kernel_all_head_dims(cuda, d, causal):
    for b, hq, hkv, sq, skv in [(1, 16, 8, 1, 300), (2, 4, 2, 77, 333),
                                (1, 8, 1, 64, 128), (3, 16, 8, 200, 200)]:
        _kernel_vs_plain(
            _card(11, b, hq, hkv, sq, skv, d, torch.bfloat16, cuda),
            BF16_TOL, causal=causal)


@pytest.mark.cuda
@pytest.mark.parametrize("sq", [1, 9, 200])
def test_sm90_kernel_at_split_boundaries(cuda, sq):
    """Per-row kv_len at and one off the split boundaries, in the split
    form (few query tiles) and the fused form (many).  Causal rows with
    q_offset = kv_len - Sq < 0 before every key get the mean of V."""
    i32 = dict(dtype=torch.int32, device=cuda)
    kv_len = torch.tensor([127, 128, 129, 255, 256, 257], **i32)
    qkv = _card(12, 6, 16, 8, sq, 300, 128, torch.bfloat16, cuda)
    for causal in (True, False):
        _kernel_vs_plain(qkv, BF16_TOL, kv_len=kv_len, causal=causal,
                         q_offset=kv_len - sq if causal else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_rows_without_a_key_match_plain(cuda, dtype):
    """Rows with kv_len 0 and causal rows before every key get the mean
    of V over all Skv keys, as ``mha_ref`` gives: in the f32 kernel and
    in both forms of the bf16 one (split: few query tiles; fused: many,
    or one split), beside rows that see keys."""
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    i32 = dict(dtype=torch.int32, device=cuda)
    for b, hq, hkv, sq, skv in [(2, 4, 2, 1, 300), (2, 4, 2, 9, 300),
                                (2, 4, 2, 40, 100), (4, 4, 2, 2000, 300)]:
        qkv = _card(13, b, hq, hkv, sq, skv, 64, dtype, cuda)
        kv_len = torch.tensor([0, skv] + [skv // 2] * (b - 2), **i32)
        if dtype == torch.bfloat16:
            p = fa.plan(dtype, "cuda", b, hq, hkv, sq, skv)
            assert p.scratch == (sq < 10)
        _kernel_vs_plain(qkv, tol, kv_len=kv_len, causal=False, q_offset=0)
        _kernel_vs_plain(qkv, tol, kv_len=kv_len, causal=True,
                         q_offset=torch.tensor([5, -3] + [-sq] * (b - 2),
                                               **i32))


@pytest.mark.cuda
def test_sm90_merge_launch_counted_in_the_split_form_only(cuda):
    q, k, v = _card(14, 1, 16, 8, 1040, 1042, 128, torch.bfloat16, cuda)
    before = (fa.launches.count, fa.merge_launches.count)
    fa.mha(q, k, v, 1040, q_offset=0)                       # fused
    fa.mha(q[:, :, 1039:].contiguous(), k, v, 1040, q_offset=1039)  # split
    torch.cuda.synchronize()
    assert (fa.launches.count, fa.merge_launches.count) == \
        (before[0] + 2, before[1] + 1)
