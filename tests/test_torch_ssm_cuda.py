"""The recurrent families on the card: xlstm-350m's and
jamba-1.5-large-398b's smoke configs (f32) on the card against the CPU,
Jamba's attention through the attention kernel and its MoE slots through
the partition-scatter kernel; a stored recurrent snapshot that later
decodes on the card leave unchanged; and ``scatter_slots`` refusing a
partition count that is not a power of two on the card, with no launch,
while a CPU tensor keeps the plain route, equal to the reference's.

The ``cuda`` tests need a card and skip without one; the CPU case needs
JAX for the reference and skips without it.  This file imports the port
only at the top, so it also runs where JAX is absent.

Tolerances: logits card against CPU within 1e-4 (f32; another summation
order in the GEMMs and in the attention kernel, as
``test_torch_families_cuda.py``); tokens, slots and drop counts exactly.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa  # noqa: E402
from repro_torch.kernels.radix_partition import ops as rp  # noqa: E402
from repro_torch.models.api import build  # noqa: E402
from repro_torch.serve.kv_repo import KVRepository  # noqa: E402
from repro_torch.serve.session import ServeSession  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

F32_LOGIT_TOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _card_vs_cpu(arch, cuda):
    """A 20-token prefill of 2 rows and 3 decode steps (the last two at
    a per-row index), on both devices from the same parameters: the
    largest logit difference."""
    cfg = get_config(arch, smoke=True)
    cpu, card = build(cfg, device="cpu"), build(cfg, device=cuda)
    p_cpu = cpu.init(0)
    p_card = tree_map(lambda t: t.to(cuda), p_cpu)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 23)))
    pos = torch.arange(23, dtype=torch.int32)
    out = []
    for m, p, dev in ((cpu, p_cpu, "cpu"), (card, p_card, cuda)):
        cache = m.init_cache(2, 24)
        b = {"tokens": toks[:, :20].to(dev), "positions": pos[:20].to(dev)}
        logits, cache = m.prefill(p, b, cache)
        steps = [logits]
        for t in range(20, 23):
            b = {"tokens": toks[:, t:t + 1].to(dev),
                 "positions": pos[t:t + 1].to(dev)}
            idx = t if t == 20 else torch.full((2,), t, dtype=torch.int32,
                                               device=dev)
            logits, cache = m.decode_step(p, b, cache, idx)
            steps.append(logits)
        out.append(torch.cat(steps, 1).float().cpu())
    return float((out[0] - out[1]).abs().max())


@pytest.mark.cuda
def test_xlstm_smoke_model_on_the_card(cuda):
    err = _card_vs_cpu("xlstm-350m", cuda)
    assert err <= F32_LOGIT_TOL, err


@pytest.mark.cuda
def test_jamba_smoke_model_on_the_card(cuda):
    """Attention through the f32 kernel, the MoE's 4 experts through the
    partition-scatter kernel, Mamba through its plain scan."""
    before = fa.launches.count, rp.scatter_launches.count
    err = _card_vs_cpu("jamba-1.5-large-398b", cuda)
    assert fa.launches.count > before[0]
    assert rp.scatter_launches.count > before[1]
    assert err <= F32_LOGIT_TOL, err


@pytest.mark.cuda
def test_xlstm_reused_state_gives_the_cold_bits_on_the_card(cuda):
    """xlstm-350m smoke in bf16 on the card: a 48-token prefill at once,
    and as 32 tokens then 16 from the carried state, give the same
    logits bit for bit (the cells' projections run in fixed row blocks,
    so the GEMMs' choice of kernel by row count cannot round the two
    differently)."""
    cfg = get_config("xlstm-350m", smoke=True).with_(dtype="bfloat16")
    model = build(cfg, device=cuda)
    params = model.init(0)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (1, 48))).to(cuda)
    pos = torch.arange(48, dtype=torch.int32, device=cuda)
    cold, _ = model.prefill(params, {"tokens": toks, "positions": pos},
                            model.init_cache(1, 48))
    cache = model.init_cache(1, 48)
    model.prefill(params, {"tokens": toks[:, :32], "positions": pos[:32]},
                  cache)
    warm, _ = model.prefill(params, {"tokens": toks[:, 32:],
                                     "positions": pos[32:]}, cache, start=32)
    assert torch.equal(cold, warm)


@pytest.mark.cuda
def test_stored_recurrent_snapshot_survives_later_decodes_on_the_card(cuda):
    """xlstm-350m smoke served twice from one prompt on the card: the
    stored state's leaves are unchanged by the first serve's decodes,
    and the exact hit gives the same tokens."""
    cfg = get_config("xlstm-350m", smoke=True)
    model = build(cfg, device=cuda)
    params = model.init(0)
    kv = KVRepository()
    sess = ServeSession(model, params, max_len=40, kv=kv)
    prompt = np.random.default_rng(3).integers(1, cfg.vocab_size, 16)
    first, _ = sess.serve(prompt, 4)
    name = kv.repository.entries[0].artifact
    before = [t.clone() for t in tree_leaves(kv.store.get(name)[0])]
    assert all(t.is_cuda for t in before)
    again, st = sess.serve(prompt, 4)
    assert st.reused_tokens == len(prompt) and st.prefilled_tokens == 0
    assert again.tolist() == first.tolist()
    after = tree_leaves(kv.store.get(name)[0])
    assert all(torch.equal(a, b) for a, b in zip(before, after))


@pytest.mark.cuda
def test_scatter_slots_refuses_a_non_power_of_two_partition_count(cuda):
    """At P = 6 a CUDA tensor raises, naming the kernel's limit, and no
    scatter is launched (the plain version is not run either)."""
    h = torch.arange(64, dtype=torch.int64, device=cuda)
    v = torch.ones(64, dtype=torch.bool, device=cuda)
    before = rp.scatter_launches.count
    with pytest.raises(ValueError, match="power of two"):
        rp.scatter_slots(h, v, n_parts=6, bucket=16)
    assert rp.scatter_launches.count == before


def test_scatter_slots_plain_route_at_six_partitions_matches_reference():
    """On the CPU, P = 6 still takes the plain route, equal to the
    reference's slots and overflow count (uneven hashes, a few invalid
    rows, buckets that overflow)."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.radix_partition.ops import \
        scatter_slots as ref_scatter_slots
    rng = np.random.default_rng(6)
    h = rng.integers(0, 1 << 32, 500, dtype=np.uint32)
    v = rng.random(500) < 0.9
    before = rp.scatter_launches.count
    overflows = []
    for bucket in (8, 100):
        slot, ovf = rp.scatter_slots(torch.from_numpy(h.astype(np.int64)),
                                     torch.from_numpy(v), n_parts=6,
                                     bucket=bucket)
        want, want_ovf = ref_scatter_slots(jnp.asarray(h), jnp.asarray(v),
                                           n_parts=6, bucket=bucket)
        np.testing.assert_array_equal(slot.numpy(), np.asarray(want))
        assert int(ovf) == int(want_ovf)
        overflows.append(int(ovf))
    assert overflows[0] > 0 and overflows[1] == 0
    assert rp.scatter_launches.count == before
