"""The port's serving path against the reference's (qwen3-1.7b smoke
config, f32, on the CPU).

The port's ``ServeSession`` and the reference's serve the same prompts
with the same parameters (carried over by ``models/convert.py``):
greedy tokens must be equal and the stored snapshots' logits and KV
within f32 round-off, cold, prefix-warm and after a round trip through
the host and remote tiers.  Prefix fingerprints and RSB1 blobs are
byte-equal to the reference's.  Also pinned: the store owns immutable
snapshots (the port writes caches in place), continuous batching equals
the sequential path, the submission semantics, the deprecated aliases,
and the reference's bf16 remote-tier fault, which both packages share.
"""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.core import prefix_plan as ref_pp  # noqa: E402
from repro.models.api import build as ref_build  # noqa: E402
from repro.serve.kv_repo import KVRepository as RefKVRepository  # noqa
from repro.serve.kv_store import KVTierStore as RefKVTierStore  # noqa
from repro.serve.session import ServeSession as RefServeSession  # noqa
from repro.service.faults import FaultInjector, FaultSchedule  # noqa
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import prefix_plan as pp  # noqa: E402
from repro_torch.models.api import build  # noqa: E402
from repro_torch.models.convert import (cache_from_numpy,  # noqa: E402
                                        params_from_numpy)
from repro_torch.serve.kv_repo import KVRepository  # noqa: E402
from repro_torch.serve.kv_store import KVTierStore  # noqa: E402
from repro_torch.serve.session import (ServeSession,  # noqa: E402
                                       ServeStats, SessionSaturated)
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(scope="module")
def setup():
    cfg = get_config("qwen3-1.7b", smoke=True)
    rm = ref_build(ref_get_config("qwen3-1.7b", smoke=True))
    rp = rm.init(jax.random.PRNGKey(0))
    pm = build(cfg, device="cpu")
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, rp),
                               "cpu")
    return cfg, rm, rp, pm, params


def _kv(tmp_path=None, injector=None, ref=False):
    root = str(tmp_path / ("ref" if ref else "port")) if tmp_path else None
    store = (RefKVTierStore if ref else KVTierStore)(remote_root=root,
                                                      injector=injector)
    return (RefKVRepository if ref else KVRepository)(store=store)


def _prompts(cfg, seed=0, shared=24, tail=8):
    rng = np.random.default_rng(seed)
    common = rng.integers(1, cfg.vocab_size, shared)
    return [np.concatenate([common, rng.integers(1, cfg.vocab_size, tail)])
            for _ in range(2)]


def _same_snapshots(port_kv, ref_kv):
    """Every stored snapshot under the same name, arrays within f32
    round-off of the reference's."""
    names = {e.artifact for e in ref_kv.repository.entries}
    assert names == {e.artifact for e in port_kv.repository.entries}
    for n in names:
        rc, rl = ref_kv.store.get(n)
        pc, pl = port_kv.store.get(n)
        for a, t in zip(jax.tree_util.tree_leaves(rc), tree_leaves(pc)):
            np.testing.assert_allclose(t.numpy(), np.asarray(a), **TOL)
        np.testing.assert_allclose(pl.numpy(), np.asarray(rl), **TOL)


# ------------------------------------------------ against the reference


@pytest.mark.parametrize("tier", ["device", "host", "remote"])
def test_serve_matches_reference_cold_warm_and_tiers(setup, tmp_path, tier):
    cfg, rm, rp, pm, params = setup
    p1, p2 = _prompts(cfg)
    ref_kv, port_kv = _kv(tmp_path, ref=True), _kv(tmp_path)
    ref = RefServeSession(rm, rp, max_len=64, kv=ref_kv)
    port = ServeSession(pm, params, max_len=64, kv=port_kv)
    cold = ServeSession(pm, params, max_len=64)
    for p in (p1, p2):                   # cold store, then an alias hit
        want, ws = ref.serve(p, 6)
        got, gs = port.serve(p, 6)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, cold.serve(p, 6)[0])
        assert gs == ServeStats(ws.prefilled_tokens, ws.reused_tokens,
                                ws.decoded_tokens, gs.wall_s)
    _same_snapshots(port_kv, ref_kv)
    for kv in (ref_kv, port_kv):
        for n in {e.artifact for e in kv.repository.entries}:
            if tier == "host":
                assert kv.store.demote_to_host(n)
            elif tier == "remote":
                assert kv.store.demote_to_remote(n)
            assert kv.store.residency(n) == tier
    want, ws = ref.serve(p2, 6)
    got, gs = port.serve(p2, 6)
    np.testing.assert_array_equal(got, want)
    assert gs.reused_tokens == ws.reused_tokens >= 24
    if tier != "device":
        assert port_kv.store.stats[f"{tier}_hits"] >= 1


def test_fingerprints_and_rsb1_blobs_byte_equal_reference(setup, tmp_path):
    """The same f32 snapshot (the reference's prefill, carried over)
    stored in both packages: the same name, and the same blob bytes on
    the remote tier."""
    cfg, rm, rp, pm, params = setup
    toks = _prompts(cfg)[0]
    assert pp.prefix_fingerprints(toks, "v0") == \
        ref_pp.prefix_fingerprints(toks, "v0")
    assert pp.prefix_plan_signature(pp.PrefixPlan(toks, "v0")) == \
        ref_pp.prefix_plan_signature(ref_pp.PrefixPlan(toks, "v0"))
    cache = rm.init_cache(1, 40)
    logits, cache = rm.prefill(
        rp, {"tokens": jnp.asarray(toks[None]),
             "positions": jnp.arange(len(toks), dtype=jnp.int32)}, cache)
    ref_kv, port_kv = _kv(tmp_path, ref=True), _kv(tmp_path)
    e_ref = ref_kv.store_prefix(toks, cache, logits=logits, every_k=8)
    e_port = port_kv.store_prefix(
        toks, cache_from_numpy(jax.tree_util.tree_map(np.asarray, cache),
                               "cpu"),
        logits=torch.from_numpy(np.array(logits)), every_k=8)
    assert e_port.artifact == e_ref.artifact
    assert e_port.bytes_out == e_ref.bytes_out
    assert sorted(port_kv.entries) == sorted(ref_kv.entries)
    assert ref_kv.store.demote_to_remote(e_ref.artifact)
    assert port_kv.store.demote_to_remote(e_port.artifact)
    name = e_ref.artifact.replace("/", "_")
    assert port_kv.store.remote.get_object(name) == \
        ref_kv.store.remote.get_object(name)


def test_prefix_entry_serializes_like_the_reference():
    """The port's serializer reads its prefix plans from
    ``core/prefix_plan.py``: the same record as the reference's, and a
    round trip."""
    from repro.core.serialize import entry_to_json as ref_entry_to_json
    from repro_torch.core.serialize import entry_from_json, entry_to_json
    toks = np.arange(12)
    kv, ref_kv = KVRepository(), RefKVRepository()
    e = kv.store_prefix(toks, {"k": torch.zeros(1024)})
    r = ref_kv.store_prefix(toks, {"k": jnp.zeros(1024)})
    kv.record_use(kv.probe(toks))
    ref_kv.record_use(ref_kv.probe(toks))
    assert entry_to_json(e) == ref_entry_to_json(r)
    back = entry_from_json(entry_to_json(e))
    assert back is not None and back.kind == "prefix"
    assert back.signature == e.signature and back.use_count == 1


def test_bf16_remote_tier_fault_shared_with_reference(tmp_path):
    """A bf16 snapshot goes to the remote tier as the reference writes
    it (dtype string ``<V2``), byte for byte; reading it back fails in
    both packages alike: the column decodes as ``|V2``, which
    ``jnp.asarray`` and ``torch.from_numpy`` refuse with TypeError.  A
    fault of the reference (ROADMAP queue 3), kept for parity."""
    rng = np.random.default_rng(0)
    k = jnp.asarray(rng.standard_normal((1, 1, 2, 8, 16)), jnp.bfloat16)
    v = jnp.asarray(rng.standard_normal((1, 1, 2, 8, 16)), jnp.bfloat16)
    logits = np.asarray(rng.standard_normal((1, 1, 32)), np.float32)
    stores = {"ref": RefKVTierStore(remote_root=str(tmp_path / "r")),
              "port": KVTierStore(remote_root=str(tmp_path / "p"))}
    stores["ref"].put("kv-x", {"slot0": (k, v)}, jnp.asarray(logits))
    stores["port"].put("kv-x", cache_from_numpy(
        {"slot0": (np.asarray(k), np.asarray(v))}, "cpu"),
        torch.from_numpy(logits))
    for s in stores.values():
        assert s.demote_to_remote("kv-x")
    assert stores["port"].remote.get_object("kv-x") == \
        stores["ref"].remote.get_object("kv-x")
    for s in stores.values():
        with pytest.raises(TypeError):
            s.get("kv-x")


# ------------------------------------------------ the port's own rules


def test_stored_snapshot_survives_later_writes(setup):
    """p1 is stored with every_k aliases; the session decodes on into
    its own cache, not the snapshot.  p2 hits p1's 24-token alias and
    prefills positions 24-31 and decodes into its copy; the stored
    snapshot is untouched and a warm p1 equals a cold p1."""
    cfg, _, _, pm, params = setup
    p1, p2 = _prompts(cfg, seed=1)
    kv = _kv()
    sess = ServeSession(pm, params, max_len=64, kv=kv)
    cold = ServeSession(pm, params, max_len=64)
    ref1, _ = cold.serve(p1, 6)
    sess.serve(p1, 6)
    (name,) = {e.artifact for e in kv.repository.entries}
    # the snapshot was copied at put: p1's decode wrote past it elsewhere
    for t in tree_leaves(kv.store.get(name)[0]):
        assert t[..., :len(p1), :].any() and not t[..., len(p1):, :].any()
    before = tree_map(torch.clone, kv.store.get(name)[0])
    _, s2 = sess.serve(p2, 6)
    assert s2.reused_tokens == 24
    after = kv.store.get(name)[0]
    for a, b in zip(tree_leaves(before), tree_leaves(after)):
        assert torch.equal(a, b)
    a1, s1 = sess.serve(p1, 6)
    assert s1.reused_tokens == len(p1)
    np.testing.assert_array_equal(a1, ref1)


def test_continuous_batching_equals_sequential(setup):
    cfg, _, _, pm, params = setup
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, cfg.vocab_size, n) for n in (9, 17, 5, 12,
                                                             20)]
    seq = ServeSession(pm, params, max_len=64)
    want = [seq.serve(p, 7)[0] for p in prompts]
    kv = _kv()
    batched = ServeSession(pm, params, n_slots=3, max_len=64, kv=kv)
    tickets = [batched.submit(p, 7) for p in prompts]
    batched.run()
    for t, w in zip(tickets, want):
        np.testing.assert_array_equal(t.result(), w)
    # a second round reuses the stored prompts' prefixes
    tickets = [batched.submit(np.concatenate([p, [3]]), 7)
               for p in prompts[:2]]
    batched.run()
    assert batched.stats["reused_tokens"] >= len(prompts[0])
    for t, p in zip(tickets, prompts[:2]):
        np.testing.assert_array_equal(
            t.result(), seq.serve(np.concatenate([p, [3]]), 7)[0])


def test_exact_hit_uses_stored_logits(setup):
    cfg, _, _, pm, params = setup
    kv = _kv()
    sess = ServeSession(pm, params, max_len=48, kv=kv)
    p = np.random.default_rng(3).integers(1, cfg.vocab_size, 16)
    ref, _ = ServeSession(pm, params, max_len=48).serve(p, 4)
    a1, _ = sess.serve(p, 4)
    a2, s2 = sess.serve(p, 4)
    assert (a1 == ref).all() and (a2 == ref).all()
    assert s2.reused_tokens == 16 and s2.prefilled_tokens == 0
    assert kv.stats()["exact_hits"] >= 1


def test_version_invalidation_r4(setup):
    cfg, _, _, pm, params = setup
    kv = _kv()
    sess = ServeSession(pm, params, max_len=48, kv=kv)
    p = np.random.default_rng(2).integers(1, cfg.vocab_size, 16)
    sess.serve(p, 2)
    assert len(kv) >= 1
    assert kv.invalidate_version("v2") >= 1 and len(kv) == 0
    assert len(kv.store) == 0
    assert kv.probe(p) is None


def test_corrupt_remote_blob_quarantined_then_cold_prefill(setup,
                                                           tmp_path):
    """The injector hook is duck-typed: the reference's FaultInjector
    flips a bit of the published blob; the splice quarantines it and the
    request prefills cold with the same output."""
    cfg, _, _, pm, params = setup
    inj = FaultInjector(FaultSchedule(0, rates={"flip": 1.0},
                                      max_faults=1))
    kv = _kv(tmp_path, injector=inj)
    sess = ServeSession(pm, params, max_len=48, kv=kv)
    p = np.random.default_rng(4).integers(1, cfg.vocab_size, 16)
    ref, _ = ServeSession(pm, params, max_len=48).serve(p, 4)
    sess.serve(p, 4)
    for e in list(kv.entries.values()):
        kv.store.demote_to_remote(e.artifact)
    assert inj.total_injected() == 1
    a, s = sess.serve(p, 4)
    assert (a == ref).all() and s.reused_tokens == 0
    assert kv.store.stats["quarantined"] >= 1


# ------------------------------------------------ submission semantics


def test_singleflight_identical_inflight_prompts(setup):
    cfg, _, _, pm, params = setup
    sess = ServeSession(pm, params, n_slots=2, max_len=48)
    p = np.random.default_rng(5).integers(1, cfg.vocab_size, 9)
    t1, t2, t3 = sess.submit(p, 4), sess.submit(p, 4), sess.submit(p, 5)
    sess.run()
    assert sess.stats["singleflight_hits"] == 1
    assert sess.stats["dup_executions"] == 0
    assert (t1.result() == t2.result()).all() and len(t3.result()) == 5


def test_tenant_round_robin_admission(setup):
    cfg, _, _, pm, params = setup
    sess = ServeSession(pm, params, n_slots=1, max_len=48)
    rng = np.random.default_rng(6)
    ta1 = sess.submit(rng.integers(1, cfg.vocab_size, 7), 1, tenant="a")
    ta2 = sess.submit(rng.integers(1, cfg.vocab_size, 7), 1, tenant="a")
    tb1 = sess.submit(rng.integers(1, cfg.vocab_size, 7), 1, tenant="b")
    sess.step()
    assert ta1.done() and not ta2.done() and not tb1.done()
    sess.step()                          # round-robin: b1 before a2
    assert tb1.done() and not ta2.done()
    sess.step()
    assert ta2.done()


def test_deadline_expiry_and_backpressure(setup):
    cfg, _, _, pm, params = setup
    sess = ServeSession(pm, params, n_slots=1, max_len=48, max_queue=2)
    rng = np.random.default_rng(7)
    long = sess.submit(rng.integers(1, cfg.vocab_size, 8), 6)
    late = sess.submit(rng.integers(1, cfg.vocab_size, 8), 2,
                       deadline_steps=1)
    with pytest.raises(SessionSaturated):
        sess.submit(rng.integers(1, cfg.vocab_size, 8), 2)
    sess.run()
    assert long.done() and len(long.result()) == 6
    with pytest.raises(RuntimeError, match="deadline"):
        late.result()
    assert sess.stats["expired"] == 1


def test_deprecated_aliases_delegate(setup):
    cfg, _, _, pm, params = setup
    from repro_torch.serve.batch_engine import BatchEngine
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.prefix_repo import PrefixRepository
    p = np.random.default_rng(8).integers(1, cfg.vocab_size, 9)
    ref, _ = ServeSession(pm, params, max_len=48).serve(p, 4)
    with pytest.warns(DeprecationWarning):
        eng = ServeEngine(pm, params, max_len=48)
    a, st = eng.serve(p, 4)
    assert (a == ref).all() and isinstance(st, ServeStats)
    with pytest.warns(DeprecationWarning):
        be = BatchEngine(pm, params, n_slots=2, max_len=48)
    r = be.submit(p, 4, rid=7)
    be.run()
    assert r.done and r.rid == 7 and (np.array(r.out) == ref).all()
    with pytest.warns(DeprecationWarning):
        repo = PrefixRepository(capacity_bytes=1 << 22)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        repo.store(np.arange(10), {"k": torch.zeros(1024)})
        hit = repo.match(np.arange(10))
    assert hit is not None and hit.length == 10
    assert repo.kv.stats()["exact_hits"] == 1
    assert repo.total_bytes == repo.kv.total_bytes == 4096
