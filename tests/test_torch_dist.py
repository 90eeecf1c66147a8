"""The port's model mesh on the CPU: the named ``LocalMesh`` and its
collectives, ``shard_map`` over PartitionSpecs, the model meshes
(``make_production_mesh``, ``make_host_mesh``, ``dp_axes``, ``tp_axis``)
and ``launch/sharding.py``'s specs against the reference's.

The reference's spec functions read only a mesh's ``shape`` and
``axis_names``, so they run here in-process on a stand-in mesh, over the
reference's ``jax.eval_shape`` trees of all 10 architectures at their
full configs; the port's run on its ``LocalMesh`` over its meta trees.
Specs are compared entry for entry; the collectives exactly against
loops over the shards.  The reference's mesh functions are called with
``jax.make_mesh`` and ``jax.devices`` stood in, so the shapes they ask
for are compared without 512 devices.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.launch import mesh as ref_mesh  # noqa: E402
from repro.launch import sharding as ref_sh  # noqa: E402
from repro.models import api as ref_api  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.launch import sharding as S  # noqa: E402
from repro_torch.launch.mesh import P  # noqa: E402
from repro_torch.models import api, dist  # noqa: E402
from repro_torch.train.compression import (  # noqa: E402
    compressed_psum, dequantize, make_compressed_sync, quantize_int8)

CPU = "cpu"
MESHES = [((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")),
          ((2, 2), ("data", "model")), ((2, 4), ("data", "model")),
          ((1, 8), ("data", "model"))]


@pytest.fixture(autouse=True)
def _reset_dist():
    yield
    dist.set_mesh(None)
    dist.set_optimized(False)


def _stacked(mesh, seed, *tail, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((mesh.n_shards,) + tail, generator=g).to(dtype)


# ------------------------------------------------------------ the mesh


def test_dist_state_defaults_and_dp_axis_names():
    assert dist.get_mesh() is None and not dist.optimized()
    mesh = M.make_host_mesh(2, 4, device=CPU)
    dist.set_mesh(mesh)
    dist.set_optimized(True)
    assert dist.get_mesh() is mesh and dist.optimized()
    assert dist.dp_axis_names(mesh) == ("data",)
    assert dist.dp_axis_names(M.make_production_mesh(
        multi_pod=True, device=CPU)) == ("pod", "data")


def test_named_mesh_shape_and_shard_order():
    mesh = M.LocalMesh((2, 3, 4), ("pod", "data", "model"), device=CPU)
    assert mesh.shape == {"pod": 2, "data": 3, "model": 4}
    assert mesh.axis_names == ("pod", "data", "model")
    assert mesh.n_shards == 24
    coords = mesh.coords()
    assert coords[0] == {"pod": 0, "data": 0, "model": 0}
    assert coords[5] == {"pod": 0, "data": 1, "model": 1}
    assert coords[23] == {"pod": 1, "data": 2, "model": 3}
    for axis in mesh.axis_names:
        np.testing.assert_array_equal(mesh.axis_index(axis).numpy(),
                                      [c[axis] for c in coords])
    with pytest.raises(ValueError):
        M.LocalMesh((2, 2), ("data",), device=CPU)
    with pytest.raises(ValueError):
        M.LocalMesh((2, 2), ("data", "data"), device=CPU)


@pytest.mark.parametrize("axis", ["data", "model", ("data", "model")])
def test_collectives_over_a_named_axis(axis):
    """psum, pmax and pmean of stacked per-shard values equal loops over
    each shard's group along the axis; every shard of a group holds the
    result."""
    mesh = M.make_host_mesh(2, 4, device=CPU)
    x = _stacked(mesh, 0, 3, 5)
    names = (axis,) if isinstance(axis, str) else axis
    coords = mesh.coords()

    def group(i):
        return [j for j, c in enumerate(coords)
                if all(c[a] == coords[i][a] for a in mesh.axis_names
                       if a not in names)]
    for op, fn in ((mesh.psum, lambda t: t.sum(0)),
                   (mesh.pmax, lambda t: t.amax(0)),
                   (mesh.pmean, lambda t: t.mean(0))):
        got = op(x, axis)
        assert got.shape == x.shape
        for i in range(mesh.n_shards):
            torch.testing.assert_close(got[i], fn(x[group(i)]), rtol=1e-6,
                                       atol=1e-6)
    n = mesh.psum(torch.ones(mesh.n_shards, dtype=torch.int32), axis)
    assert n.dtype == torch.int32 and set(n.tolist()) == {
        int(np.prod([mesh.shape[a] for a in names]))}


def test_all_to_all_over_a_named_axis():
    """Chunk j of shard s lands as chunk (s's coordinate) of the shard
    whose coordinate along the axis is j, within s's group."""
    mesh = M.make_host_mesh(2, 4, device=CPU)
    buf = torch.arange(mesh.n_shards * 4 * 3).reshape(mesh.n_shards, 4, 3)
    got = mesh.all_to_all(buf, "model")
    coords = mesh.coords()
    for s, c in enumerate(coords):
        for j in range(4):
            d = next(i for i, e in enumerate(coords)
                     if e["data"] == c["data"] and e["model"] == j)
            assert torch.equal(got[d, c["model"]], buf[s, j])
    with pytest.raises(ValueError):
        mesh.all_to_all(buf[:, :2], "model")


def test_one_dimensional_engine_api_unchanged():
    mesh = M.LocalMesh(4, device=CPU)
    assert mesh.shape == {"data": 4} and mesh.axis == "data"
    x = torch.arange(8.0)
    assert [b.tolist() for b in mesh.blocks(x)] == \
        [[0, 1], [2, 3], [4, 5], [6, 7]]
    assert float(mesh.psum(torch.tensor([1.0, 2.0, 3.0, 4.0]))) == 10.0
    buf = torch.arange(32).reshape(4, 4, 2)
    assert torch.equal(mesh.all_to_all(buf), buf.transpose(0, 1))
    out, = mesh.shard_map(lambda b: (b * 2,), x)
    assert torch.equal(out, x * 2)


def test_shard_map_splits_by_spec_and_gathers():
    """Blocks are views in the reference's layout; ``axis_index`` is the
    shard's coordinate; outputs gather by out_specs, an unnamed axis
    keeping coordinate 0's block; ``P(mesh.axis_names)`` stacks."""
    mesh = M.make_host_mesh(2, 4, device=CPU)
    x = torch.arange(4 * 8 * 3.0).reshape(4, 8, 3)
    seen = []

    def body(xb, w):
        seen.append((M.axis_index("data"), M.axis_index("model")))
        xb.add_(0.0)
        return (xb * w, xb.sum()[None] + M.axis_index("model"),
                xb[:, :1] * 0 + M.axis_index("data"))

    f = M.shard_map(body, mesh, in_specs=(P("data", "model"), P()),
                    out_specs=(P("data", "model"), P(mesh.axis_names),
                               P("data")))
    y, stacked, rows = f(x, 2.0)
    assert seen == [(d, m) for d in range(2) for m in range(4)]
    assert torch.equal(y, x * 2)
    blocks = mesh.spec_blocks(x, P("data", "model"))
    assert all(b.data_ptr() == x[2 * (i // 4):, 2 * (i % 4):]
               .data_ptr() for i, b in enumerate(blocks))
    assert torch.equal(stacked, torch.stack([b.sum() for b in blocks])
                       + torch.tensor([i % 4 for i in range(8)]))
    assert rows[:, 0, 0].tolist() == [0, 0, 1, 1]
    with pytest.raises(ValueError, match="does not split"):
        M.shard_map(body, mesh, (P("model"), P()), P())(x[:3], 1.0)


def test_shard_map_writes_land_in_the_tensor():
    mesh = M.make_host_mesh(1, 4, device=CPU)
    cache = torch.zeros(2, 16)

    def body(c):
        c[:, 0] = M.axis_index("model") + 1
        return c.sum()[None]
    M.shard_map(body, mesh, (P(None, "model"),), P(mesh.axis_names))(cache)
    assert cache[:, ::4].tolist() == [[1, 2, 3, 4]] * 2


def test_meshes_match_reference(monkeypatch):
    """The reference's mesh functions ask jax.make_mesh for these shapes and
    axes (tests/test_distributed.py's production meshes); the port's
    logical meshes are the same shapes and allocate nothing."""
    asked = []

    def make_mesh(shape, axes):
        asked.append((tuple(shape), tuple(axes)))
        return types.SimpleNamespace(shape=dict(zip(axes, shape)),
                                     axis_names=tuple(axes))
    monkeypatch.setattr(ref_mesh, "jax", types.SimpleNamespace(
        make_mesh=make_mesh, devices=lambda: [None] * 512))
    for kw in ({}, {"multi_pod": True}):
        ref = ref_mesh.make_production_mesh(**kw)
        got = M.make_production_mesh(device="meta", **kw)
        assert (got.sizes, got.axis_names) == asked[-1]
        assert got.shape == ref.shape
        assert M.dp_axes(got) == ref_mesh.dp_axes(ref)
        assert M.tp_axis(got) == ref_mesh.tp_axis(ref) == "model"
    assert M.make_production_mesh(device="meta").shape == \
        {"data": 16, "model": 16}
    assert M.make_production_mesh(multi_pod=True, device="meta").shape == \
        {"pod": 2, "data": 16, "model": 16}
    for data, model in ((1, 1), (2, 2), (2, 4)):
        ref = ref_mesh.make_host_mesh(data, model)
        got = M.make_host_mesh(data, model, device=CPU)
        assert (got.sizes, got.axis_names) == asked[-1]
        assert got.shape == ref.shape and M.dp_axes(got) == ("data",)


# ------------------------------------------------------------ the specs


def _ref_leaves(tree):
    def key(k):
        return str(getattr(k, "key", getattr(k, "idx", k)))
    leaves = jax.tree_util.tree_leaves_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return sorted(("/".join(key(k) for k in path), tuple(s))
                  for path, s in leaves)


def _port_leaves(tree, path=()):
    if isinstance(tree, P):
        return [("/".join(map(str, path)), tuple(tree))]
    if isinstance(tree, dict):
        items = tree.items()
    else:
        items = enumerate(tree)
    return sorted(x for k, v in items for x in _port_leaves(v, path + (k,)))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_match_reference(arch):
    """param_specs, opt_specs, batch_specs and cache_specs entry for
    entry, every applicable input shape, on five meshes."""
    rm = ref_api.build(ref_get_config(arch))
    pm = api.build(get_config(arch), device=CPU)
    rp, pp = rm.init_shapes(jax.random.PRNGKey(0)), pm.init_shapes()
    inputs = [(rm.input_specs(s), pm.input_specs(s)) for s in api.SHAPES
              if api.shape_applicable(pm.cfg, s)[0]]
    for sizes, axes in MESHES:
        ref = types.SimpleNamespace(shape=dict(zip(axes, sizes)),
                                    axis_names=axes)
        mesh = M.LocalMesh(sizes, axes, device="meta")
        for fn in ("param_specs", "opt_specs"):
            assert _port_leaves(getattr(S, fn)(pm.cfg, pp, mesh)) == \
                _ref_leaves(getattr(ref_sh, fn)(rm.cfg, rp, ref)), \
                (fn, sizes)
        for r_in, p_in in inputs:
            r_b, p_b = r_in.get("batch", r_in), p_in.get("batch", p_in)
            assert _port_leaves(S.batch_specs(pm.cfg, p_b, mesh)) == \
                _ref_leaves(ref_sh.batch_specs(rm.cfg, r_b, ref)), sizes
            if "cache" in r_in:
                assert _port_leaves(S.cache_specs(
                    pm.cfg, p_in["cache"], mesh)) == _ref_leaves(
                    ref_sh.cache_specs(rm.cfg, r_in["cache"], ref)), sizes


def test_named_sharding_blocks_and_refusal():
    mesh = M.make_host_mesh(2, 2, device=CPU)
    x = torch.arange(64.0).reshape(8, 8)
    named = S.to_named({"w": P("data", "model"), "b": (P(), P("model"))},
                       mesh)
    assert isinstance(named["b"][1], S.NamedSharding)
    blocks = named["w"].blocks(x)
    assert [b.shape for b in blocks] == [(4, 4)] * 4
    assert torch.equal(blocks[1], x[:4, 4:]) and \
        torch.equal(blocks[2], x[4:, :4])
    assert all(torch.equal(b, x) for b in named["b"][0].blocks(x))
    with pytest.raises(ValueError, match="does not split"):
        S.NamedSharding(M.make_host_mesh(3, 1, device=CPU),
                        P("data")).blocks(x)


def test_zero_extend_picks_largest_divisible_dim():
    mesh = M.make_production_mesh(multi_pod=True, device="meta")
    assert S.zero_extend(P(None, "model"), (64, 256), mesh) == \
        P(("pod", "data"), "model")
    assert S.zero_extend(P(), (3, 5), mesh) == P()


# ------------------------------------------------------------ int8 sync


def test_quantize_int8_rounds_half_to_even_and_clips():
    g = torch.tensor([0.5, 1.5, 2.5, -0.5, -2.5, 300.0, -300.0, 0.49])
    assert quantize_int8(g, 1.0).tolist() == [0, 2, 2, 0, -2, 127, -127, 0]
    assert quantize_int8(g, 1.0).dtype == torch.int8
    assert torch.equal(dequantize(torch.tensor([3], dtype=torch.int8),
                                  torch.tensor(0.5)), torch.tensor([1.5]))


def test_compressed_psum_is_staged_over_the_axis():
    """On a (2, 4) mesh over "model": each data row of shards gets its
    own group's mean, every shard its own error; a shared scale per
    group."""
    mesh = M.make_host_mesh(2, 4, device=CPU)
    g = _stacked(mesh, 1, 32)
    mean, err = compressed_psum(g, mesh, "model")
    for d in range(2):
        grp = g[4 * d:4 * d + 4]
        scale = grp.abs().max() / 127.0
        assert torch.equal(mean[4 * d], mean[4 * d + 3])
        q = torch.round(grp / scale).clamp(-127, 127)
        torch.testing.assert_close(mean[4 * d], (q.sum(0) * scale) / 4)
        torch.testing.assert_close(err[4 * d:4 * d + 4], grp - q * scale)


def test_compressed_sync_error_feedback_bounds():
    """tests/test_distributed.py's bounds on the port alone: each step
    within two quantization steps of the true mean, and the accumulated
    mean within 2% (error feedback removes the bias)."""
    mesh = M.LocalMesh(8, "data", device=CPU)
    sync = make_compressed_sync(mesh, ("data",))
    rng = np.random.default_rng(0)
    errors = {"w": torch.zeros(64)}
    acc_c, acc_t = np.zeros(64), np.zeros(64)
    for step in range(50):
        g = rng.normal(size=(8, 64)).astype(np.float32) * (1 + step % 3)
        mean, errors = sync({"w": torch.from_numpy(g)}, errors)
        assert errors["w"].shape == (8, 64)
        step_err = np.abs(mean["w"].numpy() - g.mean(0)).max()
        assert step_err < np.abs(g).max() / 127 * 2 + 1e-6, step_err
        acc_c += mean["w"].numpy()
        acc_t += g.mean(0)
    assert np.abs(acc_c - acc_t).max() / np.abs(acc_t).max() < 0.02
    with pytest.raises(ValueError):
        make_compressed_sync(M.make_host_mesh(2, 2, device=CPU), ("data",))
