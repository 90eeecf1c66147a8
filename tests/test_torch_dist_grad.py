"""The gradients of the port's chunked attention (``models/layers.py::
_sdpa_chunked``, the reference's path under ``dist.optimized()``)
against ``jax.grad`` of the reference's on the CPU.

The port differentiates the chunked path by running each chunk's
attention backward from the merged output and the merged row statistic
(``ref.mha_bwd_lse_ref`` here, the backward kernel on the card); the
reference differentiates its online softmax over chunks by autodiff.
Inputs are seeded numpy arrays in float32; 64-key chunks.  Tolerance:
2e-5 of the largest gradient entry (f32, two orders of summation).
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
    "causal": (dict(causal=True, q_offset=0), (2, 4, 4, 256, 256, 16, 16)),
    "gqa": (dict(causal=True, q_offset=192), (2, 8, 2, 64, 256, 32, 32)),
    "mla": (dict(causal=True, q_offset=128), (1, 4, 4, 128, 256, 24, 16)),
    "no_key": (dict(causal=True, q_offset=-40,
                    kv_len=np.array([0, 200], np.int32)),
               (2, 4, 4, 96, 256, 16, 16)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_sdpa_chunked_gradients_match_reference(case):
    """dQ, dK and dV: causal, GQA (the reference fed K and V repeated to
    the query heads, as its ``_sdpa`` does, so its dK and dV are summed
    back over each KV head's query heads), MLA's (24, 16) head dims, and
    rows that see no key in any chunk, whose dO spreads over every
    key's dV."""
    kw, (b, hq, hkv, sq, skv, d, dv) = CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    q, k, v, do = (rng.standard_normal(s).astype(np.float32) for s in (
        (b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, dv),
        (b, hq, sq, dv)))
    g = hq // hkv
    rkw, pkw = dict(kw), dict(kw)
    if "kv_len" in kw:
        rkw["kv_len"] = jnp.asarray(kw["kv_len"])
        pkw["kv_len"] = torch.from_numpy(kw["kv_len"])

    def ref(q, k, v):
        o = RL._sdpa_chunked(q, jnp.repeat(k, g, 1), jnp.repeat(v, g, 1),
                             chunk=64, **rkw)
        return jnp.sum(o * do)
    want = jax.grad(ref, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    qkv = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = L._sdpa_chunked(*qkv, chunk=64, **pkw)
    got = torch.autograd.grad(out, qkv, torch.from_numpy(do))
    for a, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(a.numpy(), w, rtol=0,
                                   atol=2e-5 * max(np.abs(w).max(), 1.0))
