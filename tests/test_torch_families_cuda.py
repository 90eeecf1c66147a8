"""The new model families' kernels on the card: the bf16 attention kernel
(``csrc/flash_attention_sm90.cu``) at MLA's unequal head dims, minicpm3's
(D_qk, D_v) = (96, 64) and the smoke config's (24, 16), in its fused and
split forms, causal or not, with per-row ``kv_len`` and ``q_offset`` and
rows that see no key, against ``ref.mha_ref``; two calls bit for bit
equal; the partition-scatter kernel at the MoE dispatch's shapes (N = T k
entries from 8 to 16384 over 128 experts, capacity 8 to 320) against
``ref.partition_scatter_ref``; and the refusals: a call at head dims no
kernel takes (in either dtype, with a gradient or without), and a MoE
dispatch over a non-power-of-two expert count raise on the card.
The model families on the card against the CPU: minicpm3's smoke config
in bf16 and qwen3-moe's (f32, dropless) with the scatter launched.
These tests need a CUDA card and skip without one; this file imports the
port only, so it also runs where JAX is absent.

Tolerances: attention within 3e-2 absolute of the plain version in bf16
(``chip_smoke.py``'s FA_TOL, the reference's attention tests' bf16
bound: the kernel rounds P to bf16 before P V), and each output row's
largest error within 0.06 of that row's RMS (its FA_REL_TOL: outputs
here are ~0.1 in size, so a kernel that lost a partial key tile can
stay under the absolute bound but not under this one).  Slots and drop counts
exactly.  Logits card against CPU: 1e-4 in f32 (another summation order
in the GEMMs), 0.125 in bf16 (8 ulps of a bf16 logit in [2, 4), as
phase 5 of ``chip_smoke.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa  # noqa: E402
from repro_torch.kernels.flash_attention.ref import mha_ref  # noqa: E402
from repro_torch.kernels.radix_partition import ops as rp  # noqa: E402
from repro_torch.kernels.radix_partition.ref import (  # noqa: E402
    partition_scatter_ref)
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.api import build  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402

FA_TOL = 3e-2
FA_REL_TOL = 0.06


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _qkv(dev, seed, b, h, sq, skv, d, dv, dtype=torch.bfloat16):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(s, generator=g, device=dev).to(dtype)
            for s in ((b, h, sq, d), (b, h, skv, d), (b, h, skv, dv))]


# (b, h, sq, skv, kwargs): the decode (split form), a 16-row suffix
# (split), a whole prefill at minicpm3's 40 heads (fused), few heads
# (split), and rows that see no key (kv_len 0, causal before every key)
def _cases(dev):
    i32 = dict(dtype=torch.int32, device=dev)
    return [
        (1, 40, 1, 300, dict(kv_len=300, q_offset=299)),
        (1, 40, 16, 300, dict(kv_len=290, q_offset=274)),
        (1, 40, 300, 300, dict()),
        (1, 40, 300, 300, dict(causal=False)),
        (2, 4, 100, 260, dict(kv_len=torch.tensor([160, 260], **i32),
                              q_offset=torch.tensor([60, 160], **i32))),
        (2, 40, 9, 300, dict(causal=False, q_offset=0,
                             kv_len=torch.tensor([0, 129], **i32))),
        (2, 40, 300, 300, dict(kv_len=torch.tensor([0, 300], **i32),
                               q_offset=torch.tensor([5, -3], **i32))),
    ]


@pytest.mark.cuda
@pytest.mark.parametrize("d,dv", [(96, 64), (24, 16)])
@pytest.mark.parametrize("case", range(7))
def test_sm90_kernel_at_mla_head_dims(cuda, d, dv, case):
    b, h, sq, skv, kw = _cases(cuda)[case]
    q, k, v = _qkv(cuda, case, b, h, sq, skv, d, dv)
    before = fa.launches.count
    got = fa.mha(q, k, v, **kw)
    again = fa.mha(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.launches.count == before + 2
    assert tuple(got.shape) == (b, h, sq, dv)
    want = mha_ref(q, k, v, **kw)
    diff = (got.float() - want.float()).abs()
    err = float(diff.max())
    rel = float((diff.amax(-1) / want.float().pow(2).mean(-1).sqrt()).max())
    assert err < FA_TOL, (case, err)
    assert rel < FA_REL_TOL, (case, rel)
    assert torch.equal(got, again)


@pytest.mark.cuda
def test_sm90_forms_cover_fused_and_split(cuda):
    forms = {fa.plan(torch.bfloat16, "cuda", b, h, h, sq, skv).scratch
             for b, h, sq, skv, _ in _cases(cuda)}
    assert forms == {True, False}


@pytest.mark.cuda
def test_unequal_head_dims_refused_where_no_kernel_takes_them(cuda):
    for dt in (torch.float32, torch.bfloat16):
        q, k, v = _qkv(cuda, 0, 1, 4, 8, 64, 96, 48, dt)
        with pytest.raises(ValueError, match="head dim"):
            fa.mha(q, k, v)
        with pytest.raises(ValueError, match="head dim"):
            fa.mha(q.requires_grad_(), k, v)


@pytest.mark.cuda
@pytest.mark.parametrize("n,cap", [(8, 8), (16, 8), (1024, 8), (2048, 16),
                                   (16384, 160), (16384, 320), (64, 320)])
def test_scatter_slots_at_moe_dispatch_shapes(cuda, n, cap):
    """Expert ids of N = T k entries over 128 experts, skewed so that
    the hottest experts overflow their capacity."""
    rng = np.random.default_rng(n + cap)
    w = 1.0 / np.arange(1, 129) ** 1.2
    e = torch.from_numpy(rng.choice(128, n, p=w / w.sum())).to(cuda)
    before = rp.scatter_launches.count
    slot, dropped = L.moe_slots(e, 128, cap)
    torch.cuda.synchronize()
    assert rp.scatter_launches.count == before + 1
    want, want_dropped = partition_scatter_ref(
        e.long(), torch.ones(n, dtype=torch.bool, device=cuda),
        n_parts=128, bucket=cap)
    assert torch.equal(slot, want)
    assert int(dropped) == int(want_dropped)


@pytest.mark.cuda
def test_moe_dispatch_refuses_a_non_power_of_two_expert_count(cuda):
    """The partition-scatter kernel takes a power-of-two partition count
    only, so 60 experts raise on the card rather than run plainly."""
    e = torch.arange(64, device=cuda) % 60
    before = rp.scatter_launches.count
    with pytest.raises(ValueError, match="power of two"):
        L.moe_slots(e, 60, 8)
    assert rp.scatter_launches.count == before


def _card_vs_cpu(arch, dtype, cuda):
    cfg = get_config(arch, smoke=True).with_(dtype=dtype)
    cpu, card = build(cfg, device="cpu"), build(cfg, device=cuda)
    p_cpu = cpu.init(0)
    p_card = tree_map(lambda t: t.to(cuda), p_cpu)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 21)))
    pos = torch.arange(21, dtype=torch.int32)
    out = []
    for m, p, dev in ((cpu, p_cpu, "cpu"), (card, p_card, cuda)):
        cache = m.init_cache(2, 24)
        b = {"tokens": toks[:, :20].to(dev), "positions": pos[:20].to(dev)}
        first, cache = m.prefill(p, b, cache)
        b = {"tokens": toks[:, 20:].to(dev), "positions": pos[20:].to(dev)}
        nxt, _ = m.decode_step(p, b, cache, 20)
        out.append(torch.cat([first, nxt], 1).float().cpu())
    return float((out[0] - out[1]).abs().max())


@pytest.mark.cuda
def test_mla_smoke_model_on_the_card(cuda):
    before = fa.launches.count
    err = _card_vs_cpu("minicpm3-4b", "bfloat16", cuda)
    assert fa.launches.count > before
    assert err <= 0.125, err


@pytest.mark.cuda
def test_moe_smoke_model_on_the_card(cuda):
    before = rp.scatter_launches.count
    err = _card_vs_cpu("qwen3-moe-235b-a22b", "float32", cuda)
    assert rp.scatter_launches.count > before
    assert err <= 1e-4, err
