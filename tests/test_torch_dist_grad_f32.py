"""More float32 gradients of the port's chunked attention
(``models/layers.py::_sdpa_chunked``) against ``jax.grad`` of the
reference's on the CPU, beside ``test_torch_dist_grad.py``: minicpm3's
(D_qk, D_v) = (96, 64), a non-causal call whose ``kv_len`` leaves the last
chunks unseen, and GQA at (24, 16).  On the CPU each chunk's backward is
``ref.mha_bwd_lse_ref`` from the merged statistic, the arithmetic the
float32 backward kernel now follows on the card (where these shapes used
to raise).  Inputs are seeded numpy arrays in float32; 64-key chunks.
Tolerance: 2e-5 of the largest gradient entry (f32, two orders of
summation), as in ``test_torch_dist_grad.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.models import layers as RL  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402

# (keywords, (B, Hq, Hkv, Sq, Skv, D, Dv))
CASES = {
    "mla_96": (dict(causal=True, q_offset=64), (1, 4, 4, 192, 256, 96, 64)),
    "kv_len": (dict(causal=False, q_offset=0, kv_len=150),
               (2, 4, 4, 64, 256, 32, 32)),
    "gqa_mla": (dict(causal=True, q_offset=0), (1, 8, 2, 256, 256, 24, 16)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_sdpa_chunked_f32_gradients_match_reference(case):
    kw, (b, hq, hkv, sq, skv, d, dv) = CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    q, k, v, do = (rng.standard_normal(s).astype(np.float32) for s in (
        (b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, dv),
        (b, hq, sq, dv)))
    g = hq // hkv

    def ref(q, k, v):
        o = RL._sdpa_chunked(q, jnp.repeat(k, g, 1), jnp.repeat(v, g, 1),
                             chunk=64, **kw)
        return jnp.sum(o * do)
    want = jax.grad(ref, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    qkv = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = L._sdpa_chunked(*qkv, chunk=64, **kw)
    assert out.dtype == torch.float32
    got = torch.autograd.grad(out, qkv, torch.from_numpy(do))
    for a, w in zip(got, want):
        w = np.asarray(w)
        assert a.shape == w.shape
        np.testing.assert_allclose(a.numpy(), w, rtol=0,
                                   atol=2e-5 * max(np.abs(w).max(), 1.0))
