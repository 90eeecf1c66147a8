"""The model mesh's paths on the card: the float32 kernel's row statistic
(``csrc/flash_attention.cu``) against ``mha_lse_ref`` beside the bf16
kernel's, chunked attention and the sequence-sharded decode through
``ops.mha_lse`` on both routes (the chunked path's backward on both
routes, each chunk's kernel reading the merged statistic),
and the expert-parallel MoE with one
partition-scatter launch a shard, each against its plain version.
These tests need a CUDA card and skip without one; this file imports the
port only, so it also runs where JAX is absent.

Tolerances: attention within 2e-5 absolute of the plain version in
float32 and 3e-2 in bf16 (``chip_smoke.py``'s FA_TOL); the statistic
within 1e-4 in float32 and 1e-3 in bf16 (its LSE_TOL), +inf on exactly
the rows that see no key; the chunked path's gradients within 2e-2 (bf16)
and 1e-4 (float32) of the largest plain entry (its BWD_TOL); slots and drop counts exactly;
logits card
against CPU within 1e-4 in float32 (another summation order in the
GEMMs).
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    mha_bwd_ref, mha_lse_ref, mha_ref)
from repro_torch.kernels.radix_partition import ops as rp  # noqa: E402
from repro_torch.kernels.radix_partition.ref import (  # noqa: E402
    partition_scatter_ref)
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models import dist  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.api import build  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402

FA_TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
LSE_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-3}
# gradients, relative to the largest plain entry (chip_smoke.py's)
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    yield torch.device("cuda")
    dist.set_mesh(None)
    dist.set_optimized(False)


def _qkv(dev, dt, b, hq, hkv, sq, skv, d, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(s, generator=g, device=dev).to(dt)
            for s in ((b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d))]


LSE_CASES = [
    ((1, 2, 2, 64, 64, 16), dict(causal=True)),
    ((2, 4, 2, 37, 200, 32), dict(causal=False)),
    ((2, 16, 8, 1, 1042, 128), dict(causal=False, q_offset=0,
                                    kv_len=[1, 1025])),
    ((2, 16, 8, 9, 300, 64), dict(kv_len=[0, 300], q_offset=[5, -3])),
    ((1, 4, 4, 200, 256, 16), dict(q_offset=-100)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", range(len(LSE_CASES)))
def test_row_statistic_matches_plain(cuda, dt, case):
    shape, kw = LSE_CASES[case]
    kw = {k: torch.tensor(v, dtype=torch.int32, device=cuda)
          if isinstance(v, list) else v for k, v in kw.items()}
    q, k, v = _qkv(cuda, dt, *shape, seed=case)
    route = "simt" if dt == torch.float32 else "sm90"
    before = fa.launches.shapes.get((route, shape[-1], shape[-1],
                                     kw.get("causal", True)), 0)
    out, lse = fa.mha_lse(q, k, v, **kw)
    assert fa.launches.shapes[(route, shape[-1], shape[-1],
                               kw.get("causal", True))] == before + 1
    want = mha_lse_ref(q, k, **kw)
    assert torch.equal(torch.isinf(lse), torch.isinf(want))
    fin = torch.isfinite(want)
    if bool(fin.any()):
        assert float((lse[fin] - want[fin]).abs().max()) < LSE_TOL[dt]
    assert float((out.float() - mha_ref(q, k, v, **kw).float()).abs()
                 .max()) < FA_TOL[dt]
    again, lse2 = fa.mha_lse(q, k, v, **kw)
    assert torch.equal(again, out) and torch.equal(lse2, lse)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kw", [dict(causal=True, q_offset=0),
                                dict(causal=True, q_offset=-64),
                                dict(causal=False, q_offset=0, kv_len=700)])
def test_chunked_attention_on_the_card(cuda, dt, kw):
    q, k, v = _qkv(cuda, dt, 2, 8, 4, 1024, 1024, 64, seed=3)
    n = fa.launches.count
    got = L._sdpa_chunked(q, k, v, chunk=256, **kw)
    assert fa.launches.count > n
    want = mha_ref(q, k, v, kw.get("kv_len"), causal=kw["causal"],
                   q_offset=kw["q_offset"])
    assert float((got.float() - want.float()).abs().max()) < FA_TOL[dt]
    # the backward: each chunk's backward kernel given the merged
    # statistic, against autograd through mha_ref
    qkv = [t.detach().requires_grad_(True) for t in (q, k, v)]
    do = torch.randn_like(got)
    out = L._sdpa_chunked(*qkv, chunk=256, **kw)
    counter = fa.backward_sm90_launches if dt == torch.bfloat16 else \
        fa.backward_simt_launches
    n = counter.count
    grads = torch.autograd.grad(out, qkv, do)
    assert counter.count > n
    want = mha_bwd_ref(q, k, v, do, kw.get("kv_len"), causal=kw["causal"],
                       q_offset=kw["q_offset"])
    for g, w in zip(grads, want):
        rel = float((g.float() - w.float()).abs().max()) / float(
            w.float().abs().max())
        assert rel < BWD_TOL[dt], rel


@pytest.mark.cuda
def test_sharded_rollout_card_matches_cpu(cuda):
    """llama4-maverick's smoke config (f32) on a (2, 4) mesh of the card:
    expert-parallel MoE layers, sequence-sharded decode; logits within
    1e-4 of the same rollout on the CPU."""
    cfg = get_config("llama4-maverick-400b-a17b", smoke=True)
    outs, base = {}, build(cfg, device="cpu").init(0)
    for dev in ("cpu", cuda):
        m = build(cfg, device=dev)
        params = tree_map(lambda x: x.to(dev), base)
        toks = torch.arange(64, dtype=torch.long).view(4, 16) % 256
        pos = torch.arange(16, dtype=torch.int32)
        dist.set_mesh(make_host_mesh(2, 4, device=dev))
        dist.set_optimized(True)
        cache = m.init_cache(4, 16)
        lg, cache = m.prefill(params, {"tokens": toks[:, :12].to(dev),
                                       "positions": pos[:12].to(dev)}, cache)
        logs = [lg.cpu()]
        for t in range(12, 16):
            lg, cache = m.decode_step(
                params, {"tokens": toks[:, t:t + 1].to(dev),
                         "positions": pos[t:t + 1].to(dev)}, cache, t)
            logs.append(lg.cpu())
        outs[str(dev)] = logs
        dist.set_mesh(None)
        dist.set_optimized(False)
    for a, b in zip(outs["cpu"], outs[str(cuda)]):
        assert float((a - b).abs().max()) < 1e-4


@pytest.mark.cuda
def test_moe_shard_slots_on_the_card(cuda, monkeypatch):
    """qwen3-moe's smoke config (f32) on (2, 2): one partition-scatter
    launch a shard, slots and drops equal to ``partition_scatter_ref``'s,
    the output within 1e-4 of the CPU's."""
    cfg = get_config("qwen3-moe-235b-a22b", smoke=True)
    p = L.init_moe(cfg, torch.Generator().manual_seed(0))
    x = torch.randn((4, 64, cfg.d_model), generator=torch.Generator()
                    .manual_seed(1))
    seen, inner = [], L.moe_slots

    def moe_slots(ids, n, cap, valid=None):
        slot, dropped = inner(ids, n, cap, valid=valid)
        lanes = ids.reshape(-1).to(torch.int64)
        want = partition_scatter_ref(lanes, valid.reshape(-1), n_parts=n,
                                     bucket=cap)
        seen.append(torch.equal(slot, want[0])
                    and int(dropped) == int(want[1]))
        return slot, dropped
    monkeypatch.setattr(L, "moe_slots", moe_slots)
    want, _ = L._moe_forward_shard_map(cfg, p, x, make_host_mesh(
        2, 2, device="cpu"))
    n = rp.scatter_launches.count
    got, _ = L._moe_forward_shard_map(
        cfg, tree_map(lambda t: t.to(cuda), p), x.to(cuda),
        make_host_mesh(2, 2, device=cuda))
    assert rp.scatter_launches.count == n + 4
    assert seen == [True] * 8
    assert float((got.cpu() - want).abs().max()) < 1e-4
