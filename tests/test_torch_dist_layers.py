"""The port's mesh paths of the model against the reference's on the CPU:
the expert-parallel MoE (``_moe_forward_shard_map``), the
sequence-sharded decode (``_decode_attn_seq_sharded``) in a whole
rollout, chunked attention (``_sdpa_chunked``) and its gate in ``_sdpa``,
the int8 gradient sync (``train/compression.py``), the elastic restore
(``restore_checkpoint(shardings=...)``), and the loss under a (2, 2)
mesh.

One reference subprocess with 8 forced host devices, as
``tests/test_distributed.py`` runs them, dumps what needs a mesh of
devices; the port runs the same inputs on the logical shards of a
``LocalMesh`` on the CPU.  Chunked attention and the losses run
in-process.

Tolerances: MoE slots, drops, int8 codes, the sync's errors and restored
blocks exactly; the MoE output within 1e-5 absolute and relative (f32
outputs up to ~10, the experts' GEMMs and the sum over "model" in
another order) and aux within 1e-6 relative; the sharded
rollout's logits within 1e-4 of the reference's sharded rollout and
2e-3 of the port's own unsharded one (tests/test_distributed.py's
bound); the sync's means within 1e-6 relative; chunked attention within
2e-5 (f32, partials merged in another arithmetic); losses within 1e-4
(tests/test_distributed.py's), the MoE's aux, averaged over DP groups
under the mesh, within its 5% of the single-device aux.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import dist as ref_dist  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models.api import build as ref_build  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.flash_attention.ref import mha_ref  # noqa: E402
from repro_torch.launch.mesh import (LocalMesh, P,  # noqa: E402
                                     make_host_mesh)
from repro_torch.launch.sharding import (  # noqa: E402
    NamedSharding, batch_specs, param_specs, to_named)
from repro_torch.models import dist  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.api import build  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.train.checkpoint import restore_checkpoint  # noqa: E402
from repro_torch.train.compression import (  # noqa: E402
    make_compressed_sync, quantize_int8)
from repro_torch.tree import tree_leaves  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"
MOE = "qwen3-moe-235b-a22b"
ROLL = "llama4-maverick-400b-a17b"
CAPACITY = (8.0, 0.5)      # the smoke config's (dropless) and one that drops
T, K, B, SMAX = 12, 4, 4, 16
SYNC_STEPS = 50
INV127 = float(np.float32(1 / 127))   # XLA's reciprocal of the constant

_REFERENCE = r"""
import dataclasses, pickle, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_config
from repro.launch.mesh import shard_map
from repro.models import dist
from repro.models.api import build
from repro.models.layers import _moe_forward_shard_map, init_moe
from repro.train.checkpoint import restore_checkpoint, save_checkpoint
from repro.train.compression import make_compressed_sync, quantize_int8

inp = dict(np.load(sys.argv[1]))
out = {}

# the expert-parallel MoE on (2, 2), and its slots by the reference's
# shard formula (layers.py:_moe_forward_shard_map's sort key)
for cf in (8.0, 0.5):
    base = get_config("qwen3-moe-235b-a22b", smoke=True)
    cfg = dataclasses.replace(base, moe=dataclasses.replace(
        base.moe, capacity_factor=cf))
    p = init_moe(cfg, jax.random.PRNGKey(0))
    x = jnp.asarray(inp["moe_x"])
    mesh = jax.make_mesh((2, 2), ("data", "model"))
    dist.set_mesh(mesh)
    with mesh:
        o, aux = jax.jit(lambda p, x: _moe_forward_shard_map(
            cfg, p, x, mesh))(p, x)
    dist.set_mesh(None)
    tag = f"moe{cf}"
    out[f"{tag}_out"], out[f"{tag}_aux"] = np.asarray(o), np.asarray(aux)
    for n, a in p.items():
        out[f"{tag}_p_{n}"] = np.asarray(a)
    m = cfg.moe
    e_loc, k = m.n_experts // 2, m.top_k
    t_loc = (x.shape[0] // 2) * x.shape[1]
    cap = max(8, (int(t_loc * k * m.capacity_factor / m.n_experts) + 7)
              // 8 * 8)
    slots, drops = [], []
    for d in range(2):
        xb = x[2 * d:2 * d + 2].reshape(-1, x.shape[2])
        probs = jax.nn.softmax(jnp.einsum("td,de->te", xb, p["router"]), -1)
        _, eidx = jax.lax.top_k(probs, k)
        flat_e = eidx.reshape(-1)
        for mi in range(2):
            lid = flat_e - mi * e_loc
            local = (lid >= 0) & (lid < e_loc)
            sort_key = jnp.where(local, lid, e_loc)
            order = jnp.argsort(sort_key)
            sorted_lid = jnp.take(sort_key, order)
            seg_start = jnp.searchsorted(sorted_lid, sorted_lid, side="left")
            rank = jnp.arange(flat_e.shape[0]) - seg_start
            keep = (sorted_lid < e_loc) & (rank < cap)
            slot = jnp.where(keep, sorted_lid * cap + rank, e_loc * cap)
            s_e = np.empty(flat_e.shape[0], np.int64)
            s_e[np.asarray(order)] = np.asarray(slot)
            k_e = np.empty(flat_e.shape[0], bool)
            k_e[np.asarray(order)] = np.asarray(keep)
            slots.append(s_e)
            drops.append(int((np.asarray(local) & ~k_e).sum()))
    out[f"{tag}_slots"] = np.stack(slots)
    out[f"{tag}_drops"] = np.asarray(drops)
    out[f"{tag}_cap"] = np.asarray(cap)

# the sequence-sharded decode in a rollout on (2, 4)
# (tests/test_distributed.py)
cfg = get_config("llama4-maverick-400b-a17b", smoke=True)
m = build(cfg)
key = jax.random.PRNGKey(0)
params = m.init(key)
T, K, B, SMAX = 12, 4, 4, 16
full = m.demo_batch(key, seq=T + K, gbs=B)

def sl(b, s0, s1):
    return {"tokens": b["tokens"][:, s0:s1],
            "positions": b["positions"][s0:s1]}

mesh = jax.make_mesh((2, 4), ("data", "model"))
dist.set_mesh(mesh); dist.set_optimized(True)
cache = m.init_cache(B, SMAX)
with mesh:
    lg, cache = m.prefill(params, sl(full, 0, T), cache)
    got = [lg]
    decode = jax.jit(m.decode_step)
    for t in range(K):
        lg, cache = decode(params, sl(full, T + t, T + t + 1), cache,
                           jnp.int32(T + t))
        got.append(lg)
    # a per-row (B,) cache index under the same gate
    try:
        m.decode_step(params, sl(full, T, T + 1), m.init_cache(B, SMAX),
                      jnp.arange(B, dtype=jnp.int32) + T)
        out["per_row_error"] = np.asarray("")
    except Exception as e:
        out["per_row_error"] = np.asarray(f"{type(e).__name__}: {e}"[:500])
dist.set_mesh(None); dist.set_optimized(False)
out["roll_tokens"] = np.asarray(full["tokens"])
for i, g in enumerate(got):
    out[f"roll_logits{i}"] = np.asarray(g)
with open(sys.argv[3], "wb") as f:
    pickle.dump(jax.tree_util.tree_map(np.asarray, params), f)

# the int8 gradient sync over (8,) "data", 50 steps of error feedback
mesh = jax.make_mesh((8,), ("data",))
sync = jax.jit(make_compressed_sync(mesh, ("data",)))

def codes_body(g, e):
    gf = g[0].astype(jnp.float32) + e
    amax = jax.lax.pmax(jnp.max(jnp.abs(gf)), "data")
    return quantize_int8(gf, jnp.maximum(amax, 1e-12) / 127.0)[None]

codes_of = jax.jit(shard_map(codes_body, mesh, in_specs=(P("data"), P()),
                             out_specs=P("data")))
rng = np.random.default_rng(0)
errors = {"w": jnp.zeros((64,), jnp.float32)}
means, errs, codes = [], [], []
with mesh:
    for step in range(50):
        g = rng.normal(size=(8, 64)).astype(np.float32) * (1 + step % 3)
        codes.append(np.asarray(codes_of(jnp.asarray(g), errors["w"])))
        mean_c, errors = sync({"w": jnp.asarray(g)}, errors)
        means.append(np.asarray(mean_c["w"]))
        errs.append(np.stack([np.asarray(s.data) for s in sorted(
            errors["w"].addressable_shards, key=lambda s: s.device.id)]))
out["sync_means"], out["sync_errors"] = np.stack(means), np.stack(errs)
out["sync_codes"] = np.stack(codes)

# the elastic restore: saved on (4,) "data", restored at (2, 2)
d = sys.argv[4]
mesh_a = jax.make_mesh((4,), ("data",))
tree = {"w": jax.device_put(jnp.arange(64.0).reshape(8, 8),
                            NamedSharding(mesh_a, P("data", None)))}
save_checkpoint(d, 3, tree)
mesh_b = jax.make_mesh((2, 2), ("data", "model"))
sh = {"w": NamedSharding(mesh_b, P("data", "model"))}
restored, _ = restore_checkpoint(d, 3, jax.eval_shape(lambda: tree), sh)
out["restore_blocks"] = np.stack([np.asarray(s.data) for s in sorted(
    restored["w"].addressable_shards, key=lambda s: s.device.id)])
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(autouse=True)
def _reset_dist():
    yield
    dist.set_mesh(None)
    dist.set_optimized(False)
    ref_dist.set_mesh(None)
    ref_dist.set_optimized(False)


def _moe_x():
    cfg = get_config(MOE, smoke=True)
    return np.random.default_rng(1).standard_normal(
        (4, 64, cfg.d_model)).astype(np.float32)


@pytest.fixture(scope="module")
def reference():
    """The reference's outputs, from one 8-device subprocess: a dict of
    arrays, its rollout's parameters and the checkpoint it saved."""
    tmp = tempfile.mkdtemp(prefix="torch_dist_")
    paths = [os.path.join(tmp, n) for n in ("in.npz", "out.npz",
                                            "params.pkl")]
    ckpt = os.path.join(tmp, "ckpt")
    np.savez(paths[0], moe_x=_moe_x())
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    proc = subprocess.run([sys.executable, "-c", _REFERENCE, *paths, ckpt],
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    z = np.load(paths[1])
    out = {k: z[k] for k in z.files}
    with open(paths[2], "rb") as f:
        out["roll_params"] = pickle.load(f)
    out["ckpt"] = ckpt
    return out


# ------------------------------------------------------------ MoE


@pytest.mark.parametrize("cf", CAPACITY)
def test_moe_shard_map_matches_reference(reference, cf, monkeypatch):
    """On (2, 2): each shard's slots and drops bit-equal to the
    reference's shard formula (e_loc 4 experts, capacity from t_loc =
    128), the output within 1e-5 and aux within 1e-6 relative."""
    tag = f"moe{cf}"
    base = get_config(MOE, smoke=True)
    cfg = dataclasses.replace(base, moe=dataclasses.replace(
        base.moe, capacity_factor=cf))
    p = {n[len(tag) + 3:]: torch.from_numpy(reference[n])
         for n in reference if n.startswith(f"{tag}_p_")}
    seen, inner = [], L.moe_slots

    def moe_slots(*a, **kw):
        slot, dropped = inner(*a, **kw)
        seen.append((slot.numpy().astype(np.int64), int(dropped), a[2]))
        return slot, dropped
    monkeypatch.setattr(L, "moe_slots", moe_slots)
    mesh = make_host_mesh(2, 2, device=CPU)
    dist.set_mesh(mesh)
    out, aux = L.moe_forward(cfg, p, torch.from_numpy(_moe_x()))
    assert len(seen) == 4
    np.testing.assert_array_equal(np.stack([s for s, _, _ in seen]),
                                  reference[f"{tag}_slots"])
    assert [d for _, d, _ in seen] == reference[f"{tag}_drops"].tolist()
    assert {c for _, _, c in seen} == {int(reference[f"{tag}_cap"])}
    if cf < 1:
        assert sum(d for _, d, _ in seen) > 0
    np.testing.assert_allclose(out.numpy(), reference[f"{tag}_out"],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(aux), float(reference[f"{tag}_aux"]),
                               rtol=1e-6)


def test_moe_shard_map_equals_single_device_when_dropless():
    """With nothing dropped the expert-parallel path is the single-device
    MoE: each token's outputs in increasing expert order on both."""
    cfg = get_config(MOE, smoke=True)
    p = L.init_moe(cfg, torch.Generator().manual_seed(0))
    x = torch.from_numpy(_moe_x())
    want, _ = L.moe_forward(cfg, p, x)
    for shape in ((2, 2), (1, 8), (4, 1)):
        got, _ = L._moe_forward_shard_map(cfg, p, x, make_host_mesh(
            *shape, device=CPU))
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


# ------------------------------------------------------------ decode


def _rollout(m, params, tokens, mesh=None):
    if mesh is not None:
        dist.set_mesh(mesh)
        dist.set_optimized(True)
    pos = torch.arange(T + K, dtype=torch.int32)
    cache = m.init_cache(B, SMAX)
    lg, cache = m.prefill(params, {"tokens": tokens[:, :T],
                                   "positions": pos[:T]}, cache)
    out = [lg]
    for t in range(K):
        lg, cache = m.decode_step(
            params, {"tokens": tokens[:, T + t:T + t + 1],
                     "positions": pos[T + t:T + t + 1]}, cache, T + t)
        out.append(lg)
    dist.set_mesh(None)
    dist.set_optimized(False)
    return out, cache


def test_sequence_sharded_rollout_matches_reference(reference):
    """llama4-maverick's smoke config on (2, 4): the MoE layers
    expert-parallel, every decode step's attention sequence-sharded
    (s_loc 4, a slice past the index adds nothing); within 1e-4 of the
    reference's sharded rollout and 2e-3 of the port's unsharded one,
    caches equal."""
    m = build(get_config(ROLL, smoke=True), device=CPU)
    params = params_from_numpy(reference["roll_params"], CPU)
    tokens = torch.from_numpy(reference["roll_tokens"])
    got, cache = _rollout(m, params, tokens, make_host_mesh(2, 4, device=CPU))
    plain, plain_cache = _rollout(m, params, tokens)
    for i, (g, w) in enumerate(zip(got, plain)):
        np.testing.assert_allclose(g.numpy(), reference[f"roll_logits{i}"],
                                   rtol=0, atol=1e-4)
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=2e-3)
    for a, b in zip(tree_leaves(cache), tree_leaves(plain_cache)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)


def test_per_row_cache_index_refused_as_in_reference(reference):
    """The reference's sharded decode cannot take a per-row (B,) index
    (its shard body's dynamic_update_slice needs a scalar start); the
    port's raises a ValueError naming the limit."""
    assert "dynamic_update_slice" in reference["per_row_error"].item()
    m = build(get_config(ROLL, smoke=True), device=CPU)
    params = m.init(0)
    dist.set_mesh(make_host_mesh(2, 4, device=CPU))
    dist.set_optimized(True)
    with pytest.raises(ValueError, match="per-row"):
        m.decode_step(params, {"tokens": torch.zeros((B, 1), dtype=torch.long),
                               "positions": torch.tensor([T],
                                                         dtype=torch.int32)},
                      m.init_cache(B, SMAX),
                      torch.arange(B, dtype=torch.int32) + T)


# ------------------------------------------------------------ chunked


def _qkv(seed, b, hq, hkv, sq, skv, d, dv):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, dv))]


CHUNK_CASES = {
    "causal": (dict(causal=True, q_offset=0), (2, 4, 4, 256, 256, 16, 16)),
    "not_causal": (dict(causal=False, q_offset=0),
                   (2, 4, 4, 96, 256, 16, 16)),
    "kv_len_rows": (dict(causal=True, q_offset=160,
                         kv_len=np.array([256, 170], np.int32)),
                    (2, 4, 4, 96, 256, 16, 16)),
    "q_offset": (dict(causal=True, q_offset=100), (1, 4, 4, 64, 256, 16, 16)),
    "gqa": (dict(causal=True, q_offset=192), (2, 8, 2, 64, 256, 32, 32)),
    "mla": (dict(causal=True, q_offset=128), (1, 4, 4, 128, 256, 24, 16)),
    "no_key": (dict(causal=True, q_offset=-40,
                    kv_len=np.array([0, 200], np.int32)),
               (2, 4, 4, 96, 256, 16, 16)),
    "kv_len_int": (dict(causal=False, q_offset=0, kv_len=100),
                   (1, 4, 4, 32, 256, 16, 16)),
}


@pytest.mark.parametrize("case", list(CHUNK_CASES))
def test_sdpa_chunked_matches_reference(case):
    """64-key chunks: causal or not, per-row and int kv_len, q_offset
    (negative too: rows before every key), GQA (the reference fed K and V
    repeated to the query heads, as its ``_sdpa`` does), MLA's (24, 16)
    head dims, rows that see no key in any chunk (the mean of V)."""
    kw, shape = CHUNK_CASES[case]
    q, k, v = _qkv(sum(map(ord, case)), *shape)
    g = shape[1] // shape[2]
    rkw = dict(kw)
    if isinstance(kw.get("kv_len"), np.ndarray):
        rkw["kv_len"] = jnp.asarray(kw["kv_len"])
    want = RL._sdpa_chunked(jnp.asarray(q), jnp.asarray(np.repeat(k, g, 1)),
                            jnp.asarray(np.repeat(v, g, 1)), chunk=64, **rkw)
    pkw = dict(kw)
    if isinstance(kw.get("kv_len"), np.ndarray):
        pkw["kv_len"] = torch.from_numpy(kw["kv_len"])
    got = L._sdpa_chunked(*map(torch.from_numpy, (q, k, v)), chunk=64,
                          **pkw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-5)
    np.testing.assert_allclose(got.numpy(), mha_ref(
        *map(torch.from_numpy, (q, k, v)), pkw.get("kv_len"),
        causal=kw["causal"], q_offset=kw["q_offset"]).numpy(),
        rtol=0, atol=2e-5)


def test_sdpa_gate_chunks_a_long_prefill():
    """qwen3-1.7b's smoke config, one 8192-token prefill into an
    8192-slot cache under dist.optimized(): every layer's attention goes
    through 4 chunks of 2048 in both packages (the gate's choice), last
    logits within 2e-5 of the reference's."""
    arch, s = "qwen3-1.7b", 8192
    rm = ref_build(ref_get_config(arch, smoke=True))
    rp = rm.init(jax.random.PRNGKey(0))
    m = build(get_config(arch, smoke=True), device=CPU)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, rp), CPU)
    tok = np.random.default_rng(2).integers(0, 256, (1, s), dtype=np.int32)
    pos = np.arange(s, dtype=np.int32)
    ref_dist.set_optimized(True)
    want, _ = rm.prefill(rp, {"tokens": jnp.asarray(tok),
                              "positions": jnp.asarray(pos)},
                         rm.init_cache(1, s))
    batch = {"tokens": torch.from_numpy(tok),
             "positions": torch.from_numpy(pos)}
    calls, inner = [], L._sdpa_chunked

    def chunked(*a, **kw):
        calls.append(kw["chunk"])
        return inner(*a, **kw)
    L._sdpa_chunked = chunked
    try:
        dist.set_optimized(True)
        got, _ = m.prefill(params, batch, m.init_cache(1, s))
    finally:
        L._sdpa_chunked = inner
    assert calls == [2048] * 2
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-5)


# ------------------------------------------------------------ sync


def test_compressed_sync_matches_reference(reference):
    """50 steps over LocalMesh(8, "data") from the reference test's
    draws: every shard's int8 codes bit-equal to the reference's, each
    shard's error bit-equal to the buffer the reference keeps on that
    device, means within 1e-6 relative."""
    mesh = LocalMesh(8, "data", device=CPU)
    sync = make_compressed_sync(mesh, ("data",))
    rng = np.random.default_rng(0)
    errors = {"w": torch.zeros(64)}
    for step in range(SYNC_STEPS):
        g = torch.from_numpy(rng.normal(size=(8, 64)).astype(np.float32)
                             * (1 + step % 3))
        gf = g + errors["w"]
        amax = mesh.pmax(gf.abs().amax(1), "data")
        codes = quantize_int8(gf, (amax.clamp_min(1e-12) * INV127)[:, None])
        np.testing.assert_array_equal(codes.numpy(),
                                      reference["sync_codes"][step])
        mean, errors = sync({"w": g}, errors)
        np.testing.assert_array_equal(errors["w"].numpy(),
                                      reference["sync_errors"][step])
        want = reference["sync_means"][step]
        np.testing.assert_allclose(mean["w"].numpy(), want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max())


# ------------------------------------------------------------ restore


def test_elastic_restore_blocks_match_reference(reference):
    """The checkpoint the reference saved on a (4,) mesh, restored by the
    port at (2, 2) with P("data", "model"): each shard's block is the
    reference's addressable shard on that device."""
    mesh = make_host_mesh(2, 2, device=CPU)
    sh = {"w": NamedSharding(mesh, P("data", "model"))}
    target = {"w": torch.empty((8, 8), device="meta")}
    restored, manifest = restore_checkpoint(reference["ckpt"], 3, target, sh)
    assert manifest["step"] == 3 and restored["w"].device.type == "cpu"
    blocks = sh["w"].blocks(restored["w"])
    np.testing.assert_array_equal(np.stack([b.numpy() for b in blocks]),
                                  reference["restore_blocks"])
    with pytest.raises(ValueError, match="does not split"):
        restore_checkpoint(reference["ckpt"], 3, target, {
            "w": NamedSharding(make_host_mesh(3, 1, device=CPU),
                               P("data"))})


# ------------------------------------------------------------ losses


@pytest.mark.parametrize("arch", ["qwen3-1.7b", MOE])
def test_loss_under_a_mesh_matches_single_device_reference(arch):
    """The smoke config with a (2, 2) mesh set (the MoE expert-parallel;
    parameters and batch laid out by their specs): the cross-entropy
    within 1e-4 of the reference's single-device loss (its own sharded
    test fails on jax 0.9); the dense model's total too; the MoE's aux,
    a Switch loss per DP group averaged (tests/test_distributed.py),
    within 5% of the single-device aux."""
    rm = ref_build(ref_get_config(arch, smoke=True))
    rp = rm.init(jax.random.PRNGKey(0))
    rb = rm.demo_batch(jax.random.PRNGKey(1), seq=16, gbs=4)
    want, (want_ce, want_aux) = rm.loss_fn(rp, rb)
    m = build(get_config(arch, smoke=True), device=CPU)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, rp), CPU)
    batch = {k: torch.from_numpy(np.array(v)) for k, v in rb.items()}
    mesh = make_host_mesh(2, 2, device=CPU)
    for tree, specs in ((params, param_specs(m.cfg, params, mesh)),
                        (batch, batch_specs(m.cfg, batch, mesh))):
        named = to_named(specs, mesh)
        for x, sh in zip(tree_leaves(tree), _shardings(named)):
            assert len(sh.blocks(x)) == 4
    dist.set_mesh(mesh)
    got, (ce, aux) = m.loss_fn(params, batch)
    assert abs(float(ce) - float(want_ce)) < 1e-4, (ce, want_ce)
    if arch == MOE:
        assert abs(float(aux) - float(want_aux)) < 0.05 * float(want_aux)
        assert abs(float(got) - float(ce) - 0.01 * float(aux)) < 1e-6
    else:
        assert abs(float(got) - float(want)) < 1e-4, (got, want)


def _shardings(tree):
    if isinstance(tree, NamedSharding):
        return [tree]
    items = sorted(tree.items()) if isinstance(tree, dict) else \
        enumerate(tree)
    return [s for _, v in items for s in _shardings(v)]
