"""The port's training path against the reference, on the CPU: AdamW,
the model's loss and every gradient leaf (qwen3-1.7b's smoke config,
parameters carried over by ``models/convert.py``), remat, the plain
attention's gradient, checkpoints written by either package, the
ReStore-fed data pipeline, the train step and the resume after a kill
(``tests/test_checkpoint.py``, ``test_pipeline.py``; DESIGN.md §4).

Tolerances: AdamW within 1e-6 relative in float32 (the global norm adds
its leaves in another order), a bf16 leaf within one bf16 rounding step
(2**-8 relative: a 1e-6 difference before the cast can cross a rounding
boundary); the loss within 1e-5 and each gradient leaf within 1e-4 of
its largest magnitude (f32 sums in another order); attention's gradient
within 1e-5; three train steps' losses within 1e-4.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.core.restore import ReStore as RReStore  # noqa: E402
from repro.dataflow import table as RTab  # noqa: E402
from repro.models.api import build as ref_build  # noqa: E402
from repro.models.layers import _sdpa as ref_sdpa  # noqa: E402
from repro.store.artifacts import ArtifactStore as RStore  # noqa: E402
from repro.store.artifacts import Catalog as RCatalog  # noqa: E402
from repro.train import checkpoint as RC  # noqa: E402
from repro.train import data as RD  # noqa: E402
from repro.train.optimizer import AdamW as RAdamW  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.restore import ReStore  # noqa: E402
from repro_torch.dataflow import table as TTab  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa  # noqa: E402
from repro_torch.kernels.flash_attention.ref import mha_bwd_ref  # noqa: E402
from repro_torch.launch.train import train, train_step  # noqa: E402
from repro_torch.models.api import build  # noqa: E402
from repro_torch.models.convert import (params_from_numpy,  # noqa: E402
                                        tensor_from_numpy)
from repro_torch.store.artifacts import ArtifactStore, Catalog  # noqa: E402
from repro_torch.train import checkpoint as TC  # noqa: E402
from repro_torch.train import data as TD  # noqa: E402
from repro_torch.train.optimizer import AdamW  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

CPU = "cpu"


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_rel(got, want, tol, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= tol * scale, what


def _t2np(t):
    return t.detach().float().numpy()


# ------------------------------------------------------------ optimizer


@pytest.mark.parametrize("state_dtype,param_dtype", [
    ("float32", "float32"), ("bfloat16", "float32"),
    ("float32", "bfloat16")])
def test_adamw_update_matches_reference(state_dtype, param_dtype):
    """Three updates from the same params and gradients: params, both
    moments, the step and gnorm (clipping active on the first update)."""
    rng = np.random.default_rng(0)
    shapes = {"a": (16, 8), "b": {"c": (8,), "d": (3, 4, 2)}}
    mk = lambda s: rng.normal(size=s).astype(np.float32)
    p_np = jax.tree_util.tree_map(mk, shapes,
                                  is_leaf=lambda x: isinstance(x, tuple))
    g_nps = [jax.tree_util.tree_map(
        lambda s, k=k: mk(s) * (3.0 if k == 0 else 0.05), shapes,
        is_leaf=lambda x: isinstance(x, tuple)) for k in range(3)]
    kw = dict(lr=1e-2, weight_decay=0.1, clip_norm=1.0,
              state_dtype=state_dtype)
    ropt, topt = RAdamW(**kw), AdamW(**kw)
    rp = jax.tree_util.tree_map(lambda a: jnp.asarray(a).astype(param_dtype),
                                p_np)
    tp = params_from_numpy(_np(rp), CPU)
    rs, ts = ropt.init(rp), topt.init(tp)
    assert ts["step"].dtype == torch.int32 and ts["step"].ndim == 0
    for g_np in g_nps:
        rg = jax.tree_util.tree_map(
            lambda a: jnp.asarray(a).astype(param_dtype), g_np)
        tg = params_from_numpy(_np(rg), CPU)
        rp, rs, rgn = ropt.update(rg, rs, rp)
        tp, ts, tgn = topt.update(tg, ts, tp)
        _assert_rel(float(tgn), float(rgn), 1e-6, "gnorm")
        assert int(ts["step"]) == int(rs["step"])
        for name, r, t in (("params", rp, tp), ("m", rs["m"], ts["m"]),
                           ("v", rs["v"], ts["v"])):
            for rl, tl in zip(jax.tree_util.tree_leaves(r),
                              tree_leaves(t)):
                assert str(tl.dtype).replace("torch.", "") == str(rl.dtype)
                tol = 2 ** -8 if rl.dtype == jnp.bfloat16 else 1e-6
                _assert_rel(_t2np(tl), np.asarray(rl, np.float32), tol,
                            name)


@pytest.mark.parametrize("chunk", [1, 7, 24, 40])
@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_adamw_updates_large_leaves_by_rows_bit_for_bit(monkeypatch, chunk,
                                                        param_dtype):
    """A leaf beyond ``optimizer.CHUNK`` elements is updated in blocks of
    rows of its leading axis (one row where a row exceeds the chunk):
    params, moments and gnorm bit for bit those of the whole-leaf
    update, for stacked, 2-d, 1-d and 0-d leaves alike."""
    from repro_torch.train import optimizer as O
    rng = np.random.default_rng(1)
    dt = getattr(torch, param_dtype)
    shapes = {"stack": (5, 3, 4), "mat": (9, 4), "vec": (30,), "s": ()}
    mk = lambda s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    p0 = {k: mk(s).to(dt) for k, s in shapes.items()}
    grads = [{k: mk(s).to(dt) * 0.3 for k, s in shapes.items()}
             for _ in range(2)]
    out = []
    for c in (1 << 26, chunk):
        monkeypatch.setattr(O, "CHUNK", c)
        opt = AdamW(lr=1e-2)
        params = {k: t.clone() for k, t in p0.items()}
        state = opt.init(params)
        norms = []
        for g in grads:
            params, state, gn = opt.update(g, state, params)
            norms.append(gn)
        out.append((params, state, norms))
    (pa, sa, na), (pb, sb, nb) = out
    for k in shapes:
        assert torch.equal(pa[k], pb[k]), k
        assert torch.equal(sa["m"][k], sb["m"][k])
        assert torch.equal(sa["v"][k], sb["v"][k])
    assert all(torch.equal(a, b) for a, b in zip(na, nb))


# --------------------------------------------------- loss and gradients


@pytest.fixture(scope="module")
def smoke_pair():
    cfg = get_config("qwen3-1.7b", smoke=True)
    rm = ref_build(ref_get_config("qwen3-1.7b", smoke=True))
    rp = rm.init(jax.random.PRNGKey(0))
    return rm, rp, build(cfg, device=CPU), cfg


def _batch_np(seed, b=2, s=16, vocab=256):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (b, s + 1)).astype(np.int32)
    return toks[:, :-1], toks[:, 1:]


def _ref_value_and_grad(rm, rp, tokens, labels):
    batch = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels),
             "positions": jnp.arange(tokens.shape[1], dtype=jnp.int32)}
    (tot, (loss, _aux)), grads = jax.value_and_grad(
        lambda p: rm.loss_fn(p, batch), has_aux=True)(rp)
    return float(tot), float(loss), grads


def _port_value_and_grad(pm, params, tokens, labels):
    for p in tree_leaves(params):
        p.requires_grad_(True)
        p.grad = None
    batch = {"tokens": torch.from_numpy(tokens),
             "labels": torch.from_numpy(labels),
             "positions": torch.arange(tokens.shape[1], dtype=torch.int32)}
    tot, (loss, _aux) = pm.loss_fn(params, batch)
    tot.backward()
    return float(tot.detach()), float(loss.detach()), params


def test_loss_and_every_gradient_leaf_match_reference(smoke_pair):
    rm, rp, pm, _cfg = smoke_pair
    tokens, labels = _batch_np(1)
    r_tot, r_loss, r_grads = _ref_value_and_grad(rm, rp, tokens, labels)
    params = params_from_numpy(_np(rp), CPU)
    t_tot, t_loss, params = _port_value_and_grad(pm, params, tokens, labels)
    assert abs(t_loss - r_loss) <= 1e-5 and abs(t_tot - r_tot) <= 1e-5
    r_leaves = jax.tree_util.tree_leaves_with_path(r_grads)
    t_leaves = tree_leaves(params)
    assert len(r_leaves) == len(t_leaves)
    for (path, rg), tp in zip(r_leaves, t_leaves):
        assert tp.grad is not None, path
        _assert_rel(_t2np(tp.grad), np.asarray(rg, np.float32), 1e-4,
                    jax.tree_util.keystr(path))


def test_remat_on_and_off_give_the_same_gradients(smoke_pair):
    _rm, rp, _pm, cfg = smoke_pair
    tokens, labels = _batch_np(2)
    grads = []
    for remat in (False, True):
        pm = build(cfg.with_(remat=remat), device=CPU)
        params = params_from_numpy(_np(rp), CPU)
        _, loss, params = _port_value_and_grad(pm, params, tokens, labels)
        grads.append([p.grad.clone() for p in tree_leaves(params)] + [
            torch.tensor(loss)])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", [
    dict(hq=4, hkv=4, sq=8, skv=8, causal=True, q_offset=0, kv_len=None),
    dict(hq=8, hkv=2, sq=5, skv=12, causal=True, q_offset=7,
         kv_len=[12, 9]),
    dict(hq=4, hkv=2, sq=6, skv=10, causal=False, q_offset=4,
         kv_len=[0, 10]),
    dict(hq=4, hkv=1, sq=6, skv=10, causal=True, q_offset=-3,
         kv_len=[10, 4]),
])
def test_mha_ref_gradients_match_reference_sdpa(case):
    """GQA, causal, q_offset (negative: early rows see no key), per-row
    kv_len (0: a row of no visible key); ``ops.backward`` on CPU tensors
    is the same plain version."""
    rng = np.random.default_rng(3)
    b, d = 2, 16
    q = rng.normal(size=(b, case["hq"], case["sq"], d)).astype(np.float32)
    k = rng.normal(size=(b, case["hkv"], case["skv"], d)).astype(np.float32)
    v = rng.normal(size=(b, case["hkv"], case["skv"], d)).astype(np.float32)
    do = rng.normal(size=q.shape).astype(np.float32)
    kv = case["kv_len"]
    rkw = dict(causal=case["causal"], q_offset=case["q_offset"],
               kv_len=None if kv is None else jnp.asarray(kv, jnp.int32))

    def f(q_, k_, v_):
        return jnp.sum(ref_sdpa(q_, k_, v_, **rkw) * do)
    want = jax.grad(f, argnums=(0, 1, 2))(q, k, v)
    got = mha_bwd_ref(torch.from_numpy(q), torch.from_numpy(k),
                      torch.from_numpy(v), torch.from_numpy(do),
                      None if kv is None else torch.tensor(kv),
                      causal=case["causal"], q_offset=case["q_offset"])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
    # the wrapper's backward takes the same plain version on the CPU
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    tkw = dict(causal=case["causal"], q_offset=case["q_offset"])
    kvt = None if kv is None else torch.tensor(kv)
    wrapped = fa.backward(tq, tk, tv, fa.mha(tq, tk, tv, kvt, **tkw), tdo,
                          kvt, **tkw)
    assert all(torch.equal(a, b) for a, b in zip(wrapped, got))


# ------------------------------------------------------------ checkpoints


def _tree_np(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(8, 16)).astype(np.float32),
            "nested": {"b": rng.normal(size=(16,)).astype(np.float32),
                       "s": np.int32(7)},
            "t": (rng.normal(size=(4,)).astype(np.float32),
                  np.ones((2, 2), np.float32))}


def _port_tree(tree_np):
    t = jax.tree_util.tree_map(lambda a: torch.tensor(np.asarray(a)),
                               tree_np)
    t["t"] = (t["t"][0], t["t"][1].to(torch.bfloat16))
    return t


def _ref_tree(tree_np):
    t = jax.tree_util.tree_map(jnp.asarray, tree_np)
    t["t"] = (t["t"][0], t["t"][1].astype(jnp.bfloat16))
    return t


def _same_values(port_tree, ref_tree):
    pl, rl = tree_leaves(port_tree), jax.tree_util.tree_leaves(ref_tree)
    assert len(pl) == len(rl)
    for p, r in zip(pl, rl):
        assert str(p.dtype).replace("torch.", "") == str(r.dtype)
        np.testing.assert_array_equal(_t2np(p),
                                      np.asarray(r, np.float32))


def test_checkpoint_roundtrip(tmp_path):
    d = str(tmp_path / "ckpt")
    tree = _port_tree(_tree_np())
    TC.save_checkpoint(d, 42, tree, extra={"note": "x"})
    assert TC.latest_step(d) == 42
    target = _port_tree(_tree_np(1))
    restored, manifest = TC.restore_checkpoint(d, 42, target)
    assert manifest["step"] == 42 and manifest["extra"]["note"] == "x"
    for a, b in zip(tree_leaves(tree), tree_leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # shardings: a tree of NamedSharding mirroring the target (the
    # elastic restore); None leaves keep the target leaf's device, and a
    # spec that does not divide its leaf raises
    from repro_torch.launch.mesh import P, make_host_mesh
    from repro_torch.launch.sharding import NamedSharding
    mesh = make_host_mesh(1, 1, device="cpu")
    shardings = tree_map(lambda _: NamedSharding(mesh, P()), target)
    again, _ = TC.restore_checkpoint(d, 42, target, shardings=shardings)
    for a, b in zip(tree_leaves(tree), tree_leaves(again)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    with pytest.raises(ValueError, match="shardings for"):
        TC.restore_checkpoint(d, 42, target, shardings=[None])


def test_torn_checkpoint_ignored(tmp_path):
    d = str(tmp_path / "ckpt")
    TC.save_checkpoint(d, 10, _port_tree(_tree_np()))
    torn = os.path.join(d, "step_00000020")
    os.makedirs(torn)
    with open(os.path.join(torn, "manifest.json"), "w") as f:
        f.write("{ this is not json")
    assert TC.latest_step(d) == 10


def test_multiple_steps_latest_wins(tmp_path):
    d = str(tmp_path / "ckpt")
    for s in (5, 10, 15):
        TC.save_checkpoint(d, s, _port_tree(_tree_np(s)))
    assert TC.latest_step(d) == 15


def test_checkpoints_cross_between_the_packages(tmp_path):
    """The same tree written by each package: the same npz keys and
    manifest fingerprint, and each restores in the other."""
    tnp = _tree_np(4)
    rd, td = str(tmp_path / "ref"), str(tmp_path / "port")
    RC.save_checkpoint(rd, 3, _ref_tree(tnp), extra={"by": "ref"})
    TC.save_checkpoint(td, 3, _port_tree(tnp), extra={"by": "ref"})
    mans = []
    for d in (rd, td):
        with open(os.path.join(d, "step_00000003", "manifest.json")) as f:
            mans.append(json.load(f))
        with np.load(os.path.join(d, "step_00000003", "arrays.npz")) as z:
            mans[-1]["files"] = sorted(z.files)
    assert mans[0] == mans[1]
    port_from_ref, _ = TC.restore_checkpoint(rd, 3, _port_tree(_tree_np()))
    _same_values(port_from_ref, _ref_tree(tnp))
    ref_from_port, _ = RC.restore_checkpoint(
        td, 3, jax.eval_shape(lambda: _ref_tree(tnp)))
    _same_values(_port_tree(tnp), ref_from_port)


# --------------------------------------------------------------- pipeline


def _port_restore(corpus_np_args=(128, 64, 1024)):
    store = ArtifactStore(device=CPU)
    cat = Catalog(store, device=CPU)
    cat.register("corpus", TD.synthetic_corpus(*corpus_np_args,
                                                device=CPU))
    return ReStore(cat, store, heuristic="aggressive",
                   min_splice_benefit_s=0.0, device=CPU)


def _ref_restore(corpus_np_args=(128, 64, 1024)):
    store = RStore()
    cat = RCatalog(store)
    cat.register("corpus", RD.synthetic_corpus(*corpus_np_args))
    return RReStore(cat, store, heuristic="aggressive",
                    min_splice_benefit_s=0.0)


def test_pipeline_gives_the_reference_rows():
    rs, ts = _ref_restore(), _port_restore()
    r_tab, _ = RD.run_pipeline(rs, rs.catalog.get("corpus"))
    t_tab, _ = TD.run_pipeline(ts, ts.catalog.get("corpus"))
    rt, tt = r_tab.to_numpy()["tokens"], t_tab.to_numpy()["tokens"]
    assert tt.dtype == np.int32 and np.array_equal(rt, tt)
    corpus = ts.catalog.get("corpus").to_numpy()
    keep = corpus["quality"] > 0.3
    assert len(tt) == len(np.unique(corpus["tokens"][keep], axis=0))


def test_rerun_fully_reused():
    ts = _port_restore()
    TD.run_pipeline(ts, ts.catalog.get("corpus"))
    _, rep2 = TD.run_pipeline(ts, ts.catalog.get("corpus"))
    assert rep2.n_executed == 0


def test_prefix_shared_between_variants():
    ts = _port_restore()
    ts.run_plan(TD.pipeline_plan(0.3, out_name="a"))
    _, rep = ts.run_plan(TD.pipeline_plan(0.3, min_length=32, out_name="b"))
    assert sum(len(j.reused_artifacts) for j in rep.jobs) > 0


def test_batches_equal_reference_with_skip_ahead():
    rs, ts = _ref_restore(), _port_restore()
    r_tab, _ = RD.run_pipeline(rs, rs.catalog.get("corpus"))
    t_tab, _ = TD.run_pipeline(ts, ts.catalog.get("corpus"))
    rb = RD.batches_from_table(r_tab, 4, 32, seed=1)
    tb = TD.batches_from_table(t_tab, 4, 32, seed=1)
    skipped = TD.batches_from_table(t_tab, 4, 32, seed=1)
    for _ in range(3):
        next(skipped)
    got = [next(tb) for _ in range(5)]
    for i in range(5):
        want = next(rb)
        assert all(np.array_equal(g, w) for g, w in zip(got[i], want))
    for i in (3, 4):
        assert all(np.array_equal(a, b)
                   for a, b in zip(next(skipped), got[i]))


def test_token_hash_matches_reference_beyond_2_31():
    """The DISTINCT hashes the 2-D int32 ``tokens`` column through the
    FNV fold of ``hash_column``.  The corpus draws ids below its vocab
    (< 2**31); ids at or above 2**31, negative as int32, must hash
    alike too."""
    rng = np.random.default_rng(5)
    toks = rng.integers(-2**31, 2**31, (64, 65), dtype=np.int64) \
        .astype(np.int32)
    toks[:4, 0] = [-1, -2**31, 2**31 - 1, 0]
    toks[10:20] = toks[:10]                      # duplicates to drop
    cols = {"tokens": toks}
    for seed in (0, 3):
        want = np.asarray(RTab.hash_columns(RTab.Table.from_numpy(cols),
                                            ["tokens"], seed))
        got = TTab.hash_columns(TTab.Table.from_numpy(cols, device=CPU),
                                ["tokens"], seed).numpy()
        assert np.array_equal(got.astype(np.uint32), want)


# ---------------------------------------------------------- train step


def test_three_train_steps_match_reference_losses(smoke_pair):
    rm, rp0, pm, cfg = smoke_pair
    ropt, topt = RAdamW(lr=3e-4), AdamW(lr=3e-4)

    @jax.jit
    def ref_step(params, opt_state, tokens, labels):
        def loss_fn(p):
            batch = {"tokens": tokens, "labels": labels,
                     "positions": jnp.arange(tokens.shape[1],
                                             dtype=jnp.int32)}
            return rm.loss_fn(p, batch)
        (_tot, (loss, _aux)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params)
        params, opt_state, gnorm = ropt.update(grads, opt_state, params)
        return params, opt_state, loss, gnorm

    rp, rs = rp0, ropt.init(rp0)
    tp = params_from_numpy(_np(rp0), CPU)
    ts = topt.init(tp)
    ts_tab, _ = TD.run_pipeline(_port_restore((64, 17, cfg.vocab_size)),
                                TD.synthetic_corpus(64, 17, cfg.vocab_size,
                                                    device=CPU))
    batches = TD.batches_from_table(ts_tab, 2, 16)
    for _ in range(3):
        tokens, labels = next(batches)
        rp, rs, r_loss, r_gn = ref_step(rp, rs, jnp.asarray(tokens),
                                        jnp.asarray(labels))
        tp, ts, t_loss, t_gn = train_step(
            pm, topt, tp, ts, torch.from_numpy(tokens),
            torch.from_numpy(labels))
        assert abs(float(t_loss) - float(r_loss)) <= 1e-4
        _assert_rel(float(t_gn), float(r_gn), 1e-4, "gnorm")


def test_train_step_refuses_a_leaf_without_gradient(smoke_pair):
    """A leaf the loss never reaches stops the step, named, before the
    optimizer touches anything (no zero gradient stands in for it)."""
    rm, rp0, pm, _cfg = smoke_pair
    opt = AdamW(lr=3e-4)
    params = params_from_numpy(_np(rp0), CPU)
    params["unused"] = torch.ones(3)
    state = opt.init(params)
    before = [t.clone() for t in tree_leaves(params)]
    tokens, labels = _batch_np(2)
    with pytest.raises(RuntimeError, match="unused"):
        train_step(pm, opt, params, state, torch.from_numpy(tokens),
                   torch.from_numpy(labels))
    assert int(state["step"]) == 0
    for a, b in zip(before, tree_leaves(params)):
        assert torch.equal(a, b.detach())


def test_train_resume_exact(tmp_path):
    """Uninterrupted run == (run to step 6, then resume) — same losses."""
    kw = dict(ckpt_every=3, quiet=True, seq_len=16, batch_size=2,
              device=CPU)
    losses_full = train(steps=10, ckpt_dir=str(tmp_path / "a"), **kw)
    d2 = str(tmp_path / "b")
    train(steps=6, ckpt_dir=d2, **kw)
    losses_resumed = train(steps=10, ckpt_dir=d2, **kw)
    assert np.allclose(losses_full[6:], losses_resumed, atol=1e-5), \
        (losses_full[6:], losses_resumed)


def test_train_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default is taken, not refused")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train(steps=1, ckpt_dir=str(tmp_path), quiet=True)


def test_tensor_leaves_carry_bf16_bits():
    """Checkpointed bf16 leaves are upcast exactly: every bf16 value
    survives the f32 npz and comes back bit for bit."""
    bits = np.arange(-2**15, 2**15, 97, dtype=np.int64).astype(np.int16)
    a = torch.from_numpy(bits).view(torch.bfloat16)
    a = a[torch.isfinite(a.float())]
    arr = TC._flatten({"a": a})["a"]
    assert arr.dtype == np.float32
    back = tensor_from_numpy(arr, CPU).to(torch.bfloat16)
    assert torch.equal(back.view(torch.int16), a.view(torch.int16))
