"""The model programs over a ``GroupMesh`` of 4 gloo ranks on the CPU,
against ``LocalMesh`` runs of the same shape and against the reference.

One spawn of 4 ranks (``launch.mesh.spawn``, a ``file://`` rendezvous
under the test's temporary directory) runs every program of
``tests/_group_model_util.py`` on each rank; a second spawn of 2 ranks
resumes the training run on another mesh shape.  The same seeded inputs
go through:

  * float ``psum``/``pmean`` (and bf16's ``pmax``) over each axis of
    (2, 2) and both, on float32 values over six decades and their bf16
    roundings: each rank's row bit-equal to ``LocalMesh``'s;
  * the expert-parallel MoE (qwen3-moe-235b-a22b's smoke config, 4 x 8
    tokens) on (2, 2) and (1, 4): each rank's DP block bit-equal to
    ``LocalMesh``'s, within MOE_TOL of the reference's one-device
    ``_moe_forward_gspmd`` and its aux within AUX_RTOL (the reference's
    own bars, ``tests/test_distributed.py``), each rank holding its E /
    tp experts;
  * llama4-maverick's smoke config prefilled and decoded on (2, 2) under
    ``dist.optimized()`` (``_group_model_util.T`` and ``K``: the decode
    crosses into the second S-slice): every step's logits of each rank's
    DP block bit-equal to ``LocalMesh``'s and within ROLL_TOL of the
    reference's one-device rollout, each rank holding its cache block
    under ``cache_specs`` and its experts;
  * the sharded training step of qwen3-1.7b's smoke config on (2, 2):
    the loss within LOSS_TOL of the reference's one-device loss, the loss
    and every gradient leaf within STEP_TOL of the one-process
    ``loss_and_grads``, bit-equal to the ``LocalMesh`` step's, and after
    STEPS AdamW steps every block of the parameters and moments within
    STEP_TOL of the one-process steps' (the global norm within STEP_TOL
    relative), each rank holding exactly its blocks under
    ``param_specs`` and ``opt_specs``;
  * ``train(mesh=...)``: 2 steps on (2, 2), checkpointed, then resumed
    on (1, 2) to step 4, every loss within STEP_TOL of an uninterrupted
    one-process run's;
  * what ranks cannot lay out or move raises (no fallback); the cache
    of a family without GQA attention is laid out whole, not refused.

Tolerances: MOE_TOL 1e-4, AUX_RTOL 5%, ROLL_TOL 2e-3, LOSS_TOL 1e-4
(the reference's); STEP_TOL 1e-5 (absolute, f32 values of size ~1; the
mean over two DP blocks of two rows each against one mean of four).
"""
import os
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

import _group_model_util as U  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models.api import build as ref_build  # noqa: E402
from repro_torch.launch.mesh import spawn  # noqa: E402
from repro_torch.launch.sharding import (cache_specs, opt_specs,  # noqa
                                         param_specs)
from repro_torch.launch.train import (batch_step, loss_and_grads,  # noqa
                                      train)
from repro_torch.train.optimizer import AdamW  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

MOE_TOL, AUX_RTOL, ROLL_TOL, LOSS_TOL, STEP_TOL = 1e-4, 0.05, 2e-3, 1e-4, \
    1e-5


def _spawn(fn, world, args):
    d = tempfile.mkdtemp(prefix="group_model_")
    return spawn(fn, world, backend="gloo", init_file=os.path.join(d, "rdv"),
                 timeout=240, args=args)


@pytest.fixture(scope="module")
def ckpt():
    return tempfile.mkdtemp(prefix="group_model_ckpt_")


@pytest.fixture(scope="module")
def ranks(ckpt):
    return _spawn(U.rank_models, 4, (ckpt,))


@pytest.fixture(scope="module")
def resumed(ranks, ckpt):
    return _spawn(U.rank_resume, 2, (ckpt,))


def _rows(coords, n=2):
    """The batch rows of the DP block at ``coords`` on (2, 2)."""
    d = int(coords[0])
    return slice(n * d, n * d + n)


def _to_ref(tree):
    return jax.tree_util.tree_map(
        jnp.asarray, tree_map(lambda t: t.detach().numpy(), tree))


# ------------------------------------------------------------ float sums
FLOAT_CASES = [f"{op}_{dt}_{ax}" for op in ("psum", "pmean")
               for dt in ("f32", "bf16") for ax in ("data", "model", "both")] \
    + ["pmax_f32_model", "pmax_bf16_model"]


@pytest.fixture(scope="module")
def local_sums():
    return U.float_sums(U.local((2, 2)), None)


@pytest.mark.parametrize("case", FLOAT_CASES)
def test_float_collectives_over_ranks_bit_equal_to_local_mesh(
        ranks, local_sums, case):
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got[f"sum_{case}"],
                                      local_sums[case][r:r + 1], case)


def test_float_sums_depend_on_their_order(local_sums):
    """The sums checked above are not order-free: the four shards'
    float32 values added last to first differ from the rank-order sum,
    which both meshes give."""
    x = U.float_inputs()
    fwd = ((x[0] + x[1]) + x[2]) + x[3]
    rev = ((x[3] + x[2]) + x[1]) + x[0]
    assert np.any(fwd != rev)
    np.testing.assert_array_equal(local_sums["psum_f32_both"][0], fwd)


# ------------------------------------------------------------ the MoE
@pytest.mark.parametrize("shape", [(2, 2), (1, 4)])
def test_moe_over_ranks_matches_local_mesh_and_reference(ranks, shape):
    tag = "".join(map(str, shape))
    want = U.moe(U.local(shape))
    cfg, p, x = U.moe_inputs()
    ref, ref_aux = RL._moe_forward_gspmd(
        ref_get_config(U.MOE, smoke=True), _to_ref(p), jnp.asarray(x.numpy()))
    e, tp = cfg.moe.n_experts, shape[1]
    b_loc = x.shape[0] // shape[0]
    for got in ranks:
        d = int(got["coords"][0]) if shape[0] > 1 else 0
        rows = slice(b_loc * d, b_loc * d + b_loc)
        out = got[f"moe{tag}_out"]
        np.testing.assert_array_equal(out, want["out"][rows])
        assert np.abs(out - np.asarray(ref)[rows]).max() < MOE_TOL
        np.testing.assert_array_equal(got[f"moe{tag}_aux"], want["aux"])
        assert abs(float(got[f"moe{tag}_aux"]) - float(ref_aux)) \
            <= AUX_RTOL * float(ref_aux)
        np.testing.assert_array_equal(
            got[f"moe{tag}_experts_held"],
            [p[k].numel() * (e // tp) // e for k in ("wg", "wu", "wd")])


# ------------------------------------------------------------ the rollout
def test_rollout_over_ranks_matches_local_mesh_and_reference(ranks):
    want = U.rollout(U.local((2, 2)))
    cfg = U.get_config(U.ROLL, smoke=True)
    pm = U.build(cfg, device="cpu")
    params = pm.init(seed=0)
    rm = ref_build(ref_get_config(U.ROLL, smoke=True))
    rp = _to_ref(params)
    toks = U.rollout_tokens(cfg).numpy().astype(np.int32)
    cache = rm.init_cache(U.B, U.SMAX)
    lg, cache = rm.prefill(rp, {"tokens": jnp.asarray(toks[:, :U.T]),
                                "positions": jnp.arange(U.T, dtype=jnp.int32)},
                           cache)
    ref = [np.asarray(lg)]
    decode = jax.jit(rm.decode_step)
    for t in range(U.T, U.T + U.K):
        lg, cache = decode(rp, {"tokens": jnp.asarray(toks[:, t:t + 1]),
                                "positions": jnp.asarray([t], jnp.int32)},
                           cache, jnp.int32(t))
        ref.append(np.asarray(lg))
    ref = np.stack(ref)
    whole_cache = pm.init_cache(U.B, U.SMAX)
    named = cache_specs(cfg, whole_cache, U.local((2, 2)))
    experts = U.expert_specs(params, U.local((2, 2)))
    mesh = U.local((2, 2))
    for got in ranks:
        rows = _rows(got["coords"])
        lg = got["roll_logits"]
        np.testing.assert_array_equal(lg, want["logits"][:, rows])
        assert np.abs(lg - ref[:, rows]).max() < ROLL_TOL
        c = dict(zip(U.AXES, map(int, got["coords"])))
        np.testing.assert_array_equal(got["roll_cache_held"], [
            mesh.block(x, s, c).numel() for x, s in zip(
                tree_leaves(whole_cache), U.spec_leaves(named))])
        held = [mesh.block(x, s, c).numel() for x, s in zip(
            tree_leaves(params), U.spec_leaves(experts))
            if x.ndim == 4]
        np.testing.assert_array_equal(got["roll_experts_held"], held)
        assert sum(held) < sum(x.numel() for x in tree_leaves(params)
                               if x.ndim == 4)


# ------------------------------------------------------------ the step
@pytest.fixture(scope="module")
def one_process():
    """The one-process step on the whole batch: (loss, grads, the params
    and moments after STEPS steps, their gnorms)."""
    model, batch = U.step_inputs()
    params = model.init(seed=0)
    loss, grads = loss_and_grads(model, params, batch)
    grads = [g.clone() for g in tree_leaves(grads)]
    opt = AdamW()
    state = opt.init(params)
    gnorms = []
    for _ in range(U.STEPS):
        params, state, _, gn = batch_step(model, opt, params, state, batch)
        gnorms.append(float(gn))
    return float(loss), grads, params, state, gnorms


def test_sharded_step_loss_and_gradients(ranks, one_process):
    model, batch = U.step_inputs()
    rm = ref_build(ref_get_config(U.DENSE, smoke=True))
    rb = {k: jnp.asarray(v.numpy().astype(np.int32)) for k, v in
          batch.items()}
    ref_loss = float(rm.loss_fn(_to_ref(model.init(seed=0)), rb)[0])
    want = U.sharded_step(U.local((2, 2)))
    loss, grads, _, _, _ = one_process
    for got in ranks:
        assert abs(float(got["step_loss"]) - ref_loss) < LOSS_TOL
        assert abs(float(got["step_loss"]) - loss) < STEP_TOL
        np.testing.assert_array_equal(got["step_loss"], want["loss"])
        for i, g in enumerate(grads):
            np.testing.assert_allclose(got[f"step_grad{i}"], g.numpy(),
                                       rtol=0, atol=STEP_TOL)
            np.testing.assert_array_equal(got[f"step_grad{i}"],
                                          want[f"grad{i}"])
        np.testing.assert_array_equal(got["step_losses"], want["losses"])
        np.testing.assert_array_equal(got["step_gnorms"], want["gnorms"])


def test_sharded_steps_update_each_ranks_blocks(ranks, one_process):
    _, _, params, state, gnorms = one_process
    model, _ = U.step_inputs()
    mesh = U.local((2, 2))
    shapes = model.init_shapes()
    pspecs = U.spec_leaves(param_specs(model.cfg, shapes, mesh))
    ospecs = U.spec_leaves(opt_specs(model.cfg, shapes, mesh)["m"])
    whole = {"param": (tree_leaves(params), pspecs),
             "m": (tree_leaves(state["m"]), ospecs),
             "v": (tree_leaves(state["v"]), ospecs)}
    for got in ranks:
        c = dict(zip(U.AXES, map(int, got["coords"])))
        assert int(got["step_step"]) == U.STEPS
        np.testing.assert_allclose(got["step_gnorms"], gnorms, rtol=STEP_TOL)
        for kind, (leaves, specs) in whole.items():
            for i, (x, s) in enumerate(zip(leaves, specs)):
                blk = mesh.block(x.detach(), s, c)
                held = got[f"step_{kind}{i}"]
                # the rank holds exactly its block's elements
                assert held.shape == tuple(blk.shape), (kind, i, s)
                np.testing.assert_allclose(held, blk.float().numpy(), rtol=0,
                                           atol=STEP_TOL)
        n_held = sum(got[f"step_param{i}"].size for i in range(len(pspecs)))
        assert n_held < sum(x.numel() for x in tree_leaves(params))


# ------------------------------------------------------------ refusals
def test_what_ranks_cannot_lay_out_or_move_raises(ranks):
    """No fallback to a whole run on one rank: a sequence-sharded GQA cache
    of a length the "model" axis does not split, a MoE given every expert
    on a rank, a bf16 all_reduce (gloo has none).  The cache is laid out
    leaf by leaf, so a family without GQA attention (xLSTM, MLA) holds
    its cache whole and the encoder-decoder family its self-attention's
    S-slices: those no longer raise (``launch/sharded_serve.py`` serves
    them)."""
    for got in ranks:
        assert got["refusals"] == {
            "cache_xlstm-350m": "", "cache_minicpm3-4b": "",
            "cache_seamless-m4t-medium": "",
            "cache_15_positions": "ValueError",
            "moe_whole_experts": "ValueError", "all_reduce_bf16": "TypeError"}


# ------------------------------------------------------------ train()
def test_train_checkpoints_blocks_and_resumes_on_another_mesh(
        ranks, resumed):
    ckpt = tempfile.mkdtemp(prefix="group_model_whole_")
    want = train(steps=4, ckpt_dir=ckpt, **U.TRAIN)
    for got in ranks:
        np.testing.assert_allclose(got["train"], want[:2], rtol=0,
                                   atol=STEP_TOL)
    for got in resumed:
        assert len(got) == 2
        np.testing.assert_allclose(got, want[2:], rtol=0, atol=STEP_TOL)
