"""The sharded prefill and decode steps (``launch/sharded_serve.py``) over
a ``GroupMesh`` of 4 gloo ranks on (2, 2), against ``LocalMesh(2, 2)``,
the reference's one-device serving and the counting mesh.

One spawn of 4 ranks runs ``tests/_group_serve_util.py::rank_serve``:
the smoke configs of qwen3-1.7b (dense), llama4-maverick (experts: the
expert-parallel MoE under ``optimized``) and minicpm3-4b (MLA, whose
cache ``optimized`` serves whole), each a T-token prefill and K decode
steps, baseline and ``optimized``.  For each:

  * every call's logits on every rank bit-equal to ``LocalMesh``'s, and
    each rank's cache blocks bit-equal to the blocks of ``LocalMesh``'s
    cache at its coordinates under ``cache_specs``;
  * the logits within TOL of the reference's one-device prefill and
    decode on the same weights (the port's seeded parameters carried
    across as numpy), the serving tests' tolerance;
  * each rank's transport, call by call (calls and bytes by kind), equal
    to a ``CountingMesh`` of that rank counting the same call on the
    ``meta`` device; ``sharded_train_step``'s too.
"""
import functools
import os
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

import _group_serve_util as U  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models.api import build as ref_build  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.mesh import CountingMesh, LocalMesh, spawn  # noqa
from repro_torch.launch.sharded_serve import cache_shardings  # noqa: E402
from repro_torch.models.api import build  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)         # tests/test_torch_serve.py's
CASES = [(a, o) for a in U.ARCHS for o in (False, True)]


@pytest.fixture(scope="module")
def ranks():
    d = tempfile.mkdtemp(prefix="group_serve_")
    return spawn(U.rank_serve, 4, backend="gloo",
                 init_file=os.path.join(d, "rdv"), timeout=240)


def _local():
    return LocalMesh(U.SHAPE, U.AXES, device="cpu")


def _spec_leaves(named):
    return [sh.spec for sh in tree_leaves(named)]


@functools.lru_cache(maxsize=None)
def _reference(arch):
    """The reference's one-device prefill and K decode steps on the
    port's seeded weights: (1 + K, B, V) last-token logits."""
    cfg = get_config(arch, smoke=True)
    params = build(cfg, device="cpu").init(0)
    rp = jax.tree_util.tree_map(
        jnp.asarray, tree_map(lambda t: t.detach().float().numpy()
                              if t.dtype == torch.bfloat16 else
                              t.detach().numpy(), params))
    rm = ref_build(ref_get_config(arch, smoke=True))
    toks = U.tokens(cfg).numpy().astype(np.int32)
    cache = rm.init_cache(U.B, U.SMAX)
    lg, cache = rm.prefill(rp, {"tokens": jnp.asarray(toks[:, :U.T]),
                                "positions": jnp.arange(U.T,
                                                        dtype=jnp.int32)},
                           cache)
    out = [np.asarray(lg)[:, -1]]
    decode = jax.jit(rm.decode_step)
    for t in range(U.T, U.T + U.K):
        lg, cache = decode(rp, {"tokens": jnp.asarray(toks[:, t:t + 1]),
                                "positions": jnp.asarray([t], jnp.int32)},
                           cache, jnp.int32(t))
        out.append(np.asarray(lg)[:, -1])
    return np.stack(out)


@pytest.mark.parametrize("arch,opt", CASES)
def test_sharded_serving_over_ranks_is_local_meshs_and_the_references(
        ranks, arch, opt):
    want = U.serve(_local(), arch, opt)
    ref = _reference(arch)
    np.testing.assert_allclose(want["logits"], ref, **TOL)
    model = build(get_config(arch, smoke=True), device="cpu")
    specs = _spec_leaves(cache_shardings(model, _local(), U.B, U.SMAX))
    split = 0
    for got in ranks:
        g = got[arch, opt]
        np.testing.assert_array_equal(g["logits"], want["logits"])
        for x, blk, s in zip(want["cache"], g["cache"], specs):
            want_blk = _local().block(torch.from_numpy(x), s,
                                      got["coords"]).numpy()
            np.testing.assert_array_equal(blk, want_blk)
            split += blk.size < x.size
    assert split > 0                 # the ranks hold blocks, not caches


@pytest.mark.parametrize("arch,opt", CASES)
def test_each_ranks_transport_is_the_counting_meshs(ranks, arch, opt):
    for r, got in enumerate(ranks):
        count = U.serve(CountingMesh(U.SHAPE, U.AXES, rank=r,
                                     device="meta"), arch, opt)
        assert got[arch, opt]["calls"] == count["calls"], r
        assert got[arch, opt]["calls"][0]["all_gather"][0] > 0


def test_optimized_routes_keep_experts_and_s_slices(ranks):
    """Under ``optimized`` the experts stay blocks and the GQA cache its
    S-slices: fewer bytes cross than in the baseline; MLA's latent is
    gathered whole either way, so its transport does not change."""
    for got in ranks:
        for arch in U.ARCHS:
            base, opt = (sum(b for _, b in c.values())
                         for c in (got[arch, False]["calls"][1],
                                   got[arch, True]["calls"][1]))
            if arch == "minicpm3-4b":
                assert opt == base
            else:
                assert opt < base, arch


def test_sharded_train_step_transport_is_the_counting_meshs(ranks):
    for r, got in enumerate(ranks):
        count = U.train_transport(CountingMesh(U.SHAPE, U.AXES, rank=r,
                                               device="meta"))
        assert got["train"]["calls"] == count["calls"], r
        assert got["train"]["loss"] == ranks[0]["train"]["loss"]
