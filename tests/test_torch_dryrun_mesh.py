"""The dry-run per device of a mesh (``launch/dryrun.py`` with a mesh,
``launch/mesh.py::CountingMesh``) and the roofline's two links, on the
CPU.

  * (a) rank 0's resident bytes on a (2, 4) mesh equal the reference's
    compiled ``memory_analysis().argument_size_in_bytes`` for a train
    step and a decode step with its cache (the reference in a subprocess
    with 8 forced host devices);
  * (b) the train step's per-device FLOPs on a (2, 2) mesh equal the
    one-card count at batch B / 2 exactly, and on (1, 1) equal
    ``lower_cell``'s one-card FLOPs;
  * (c) the depth-extrapolated collective counts and bytes equal a
    full-depth count, the xLSTM loops' length extrapolation too;
  * the counting mesh's primitives: shapes, the transport rule, the
    reference's names, the node crossing;
  * (e) the roofline's collective term is NVLink bytes over NVLINK_BW
    plus network bytes over NET_BW.

The CLI's ``--multi-pod`` and ``--opt`` reports are held in
``tests/test_torch_dryrun_counts.py``.
"""
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch.mesh import CountingMesh, P  # noqa: E402
from repro_torch.roofline import analysis as ra  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESH24 = ((2, 4), ("data", "model"))
MESH22 = ((2, 2), ("data", "model"))
COLL_KEYS = ("collective_bytes", "collective_counts",
             "collective_bytes_by_link")

# the reference's steps compiled on a (2, 4) mesh of forced host devices,
# as its dry-run compiles them (in_shardings from its specs)
REF_ARGS = """
import json
import jax, jax.numpy as jnp
from repro.configs import get_config
from repro.models.api import build
from repro.train.optimizer import AdamW
from repro.launch.mesh import make_host_mesh
from repro.launch.sharding import (batch_specs, cache_specs, opt_specs,
                                   param_specs, to_named)
cfg = get_config("qwen3-1.7b", smoke=True)
model = build(cfg)
mesh = make_host_mesh(2, 4)
ps = model.init_shapes(jax.random.PRNGKey(0))
p_sh = to_named(param_specs(cfg, ps, mesh), mesh)
i32 = lambda *s: jax.ShapeDtypeStruct(s, jnp.int32)
out = {}
with mesh:
    opt = AdamW(state_dtype="float32")
    os_ = jax.eval_shape(opt.init, ps)
    o_sh = to_named(opt_specs(cfg, ps, mesh), mesh)
    b = {"tokens": i32(8, 64), "labels": i32(8, 64), "positions": i32(64)}
    b_sh = to_named(batch_specs(cfg, b, mesh), mesh)
    def step(p, o, b):
        (t, (l, a)), g = jax.value_and_grad(model.loss_fn, has_aux=True)(p, b)
        p, o, gn = opt.update(g, o, p)
        return p, o, l, gn
    c = jax.jit(step, in_shardings=(p_sh, o_sh, b_sh),
                out_shardings=(p_sh, o_sh, None, None)).lower(ps, os_, b)
    out["train"] = c.compile().memory_analysis().argument_size_in_bytes
    cache = jax.eval_shape(lambda: model.init_cache(8, 128))
    b = {"tokens": i32(8, 1), "positions": i32(1)}
    b_sh = to_named(batch_specs(cfg, b, mesh), mesh)
    c_sh = to_named(cache_specs(cfg, cache, mesh), mesh)
    c = jax.jit(lambda p, b, cc, i: model.decode_step(p, b, cc, i),
                in_shardings=(p_sh, b_sh, c_sh, None),
                out_shardings=(None, c_sh)).lower(ps, b, cache, i32())
    out["decode"] = c.compile().memory_analysis().argument_size_in_bytes
print(json.dumps(out))
"""


def _reference_argument_bytes():
    """The reference's per-device argument bytes, in a subprocess that
    forces 8 host devices before JAX starts (this process keeps one)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", REF_ARGS], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _smoke():
    return get_config("qwen3-1.7b", smoke=True)


# ------------------------------------------------------------------ (a)
def test_rank_resident_bytes_are_the_references_argument_bytes():
    pytest.importorskip("jax")
    want = _reference_argument_bytes()
    train = D._step_cost(_smoke(), "train", 64, 8, None, MESH24)
    decode = D._step_cost(_smoke(), "decode", 128, 8, None, MESH24)
    assert sum(train["resident_bytes"].values()) == want["train"] == 185604
    assert sum(decode["resident_bytes"].values()) == want["decode"]
    # the parameters' blocks are about a quarter of the whole parameters
    # (the norms are whole), the peak above what is resident
    whole = sum(x.numel() * x.element_size()
                for x in _model_shapes(_smoke()))
    assert train["resident_bytes"]["parameters"] < whole / 2
    assert train["peak_bytes"] > sum(train["resident_bytes"].values())


def _model_shapes(cfg):
    from repro_torch.models.api import META, build
    from repro_torch.tree import tree_leaves
    return tree_leaves(build(cfg, device=META).init_shapes())


# ------------------------------------------------------------------ (b)
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "llama4-maverick-400b-a17b",
                                  "minicpm3-4b", "seamless-m4t-medium"])
def test_train_step_flops_per_device_are_the_one_card_count_at_b_over_d(
        arch):
    """Each device runs the whole model on its DP block; the gathers,
    the DP mean and the sharded update add no matmul-class FLOP."""
    cfg = get_config(arch, smoke=True)
    mesh = D._step_cost(cfg, "train", 32, 4, None, MESH22)
    card = D._step_cost(cfg, "train", 32, 2)
    assert mesh["flops"] == card["flops"] > 0
    assert mesh["flops_by_dtype"] == card["flops_by_dtype"]


def test_train_step_flops_on_one_by_one_are_lower_cells():
    kw = dict(seq=128, batch=2)
    card = D.lower_cell("qwen3-1.7b", "train_4k", **kw)
    one = D.lower_cell("qwen3-1.7b", "train_4k",
                       mesh=((1, 1), ("data", "model")), **kw)
    assert one["mesh"] == "1x1" and card["mesh"] == "1xH100"
    assert one["cost_extrapolated"]["flops"] == \
        card["cost_extrapolated"]["flops"]
    assert one["cost_extrapolated"]["flops_by_dtype"] == \
        card["cost_extrapolated"]["flops_by_dtype"]
    # nothing crosses a link, but the mesh's gathers are counted
    c = one["cost_extrapolated"]
    assert c["collective_bytes_by_link"]["network"] == 0
    assert c["collective_counts"]["all-gather"] > 0


# ------------------------------------------------------------------ (c)
def _three_periods(arch):
    cfg = get_config(arch, smoke=True)
    if cfg.family == "encdec":
        return cfg.with_(n_layers=3, n_encoder_layers=3)
    return D._depth_variant(cfg, 3)


@pytest.mark.parametrize("arch,kind,opt", [
    ("qwen3-1.7b", "train", False),
    ("llama4-maverick-400b-a17b", "decode", True),
    ("jamba-1.5-large-398b", "prefill", True),
    ("seamless-m4t-medium", "decode", True),
])
def test_depth_extrapolated_collectives_equal_a_full_depth_count(
        arch, kind, opt):
    cfg = _three_periods(arch)
    got = D.extrapolated_cost(cfg, kind, 128, 4, mesh=MESH22,
                              optimized=opt)
    want = D._step_cost(cfg, kind, 128, 4, None, MESH22, opt)
    for k in COLL_KEYS:
        assert got[k] == {d: int(v) for d, v in want[k].items()}, k
    assert got["collective_counts"]["all-gather"] > 0
    assert got["flops"] == want["flops"] and got["bytes"] == want["bytes"]


def test_loop_extrapolated_collectives_equal_the_full_loop_count():
    """xLSTM's loops over time counted at LOOP_STEPS and twice as many
    on a mesh (a prefill): the collectives, gathered once a step whatever
    its length, equal the full loop's."""
    import dataclasses
    cfg = get_config("xlstm-350m", smoke=True)
    cfg = cfg.with_(n_layers=2, xlstm=dataclasses.replace(cfg.xlstm,
                                                          slstm_every=2))
    s, mesh = 4 * D.LOOP_STEPS, ((1, 2), ("data", "model"))
    got = D._cell_cost(cfg, "prefill", s, 1, mesh=mesh,
                       costs=[D._step_cost(*a) for a in
                              D._counts(cfg, "prefill", s, 1, None, mesh)])
    want = D._step_cost(cfg, "prefill", s, 1, None, mesh)
    for k in COLL_KEYS:
        assert got[k] == want[k], k


# ------------------------------------------------------ the counting mesh
def test_counting_mesh_primitives_count_without_moving():
    m = CountingMesh((2, 16, 16), ("pod", "data", "model"), device="meta")
    assert m.my_coords == {"pod": 0, "data": 0, "model": 0}
    x = torch.empty((3, 5), dtype=torch.bfloat16, device="meta")
    whole = m.globalize(x, P(None, "model"))
    assert whole.shape == (3, 80) and whole.device.type == "meta"
    assert dict(m.transport["all_gather"]) == {"calls": 1, "bytes": 30,
                                               "seconds": 0.0}
    assert m.collective_bytes["all-gather"] == 16 * 30
    # rank 0's "model" group is ranks 0-15: two nodes of 8
    assert m.link_bytes == {"nvlink": 0, "network": 16 * 30}
    y = torch.empty((1, 4), device="meta")
    assert m.pmax(y, "model").shape == (1, 4)
    assert m.collective_counts["all-reduce"] == 1
    assert m.all_to_all(torch.empty((1, 2, 3), device="meta"),
                        "pod").shape == (1, 2, 3)
    assert m.agree("plan") == "plan" and m.transport["broadcast"]["calls"]
    with pytest.raises(TypeError):
        m.sum_ranks(torch.empty(2, dtype=torch.bfloat16, device="meta"))
    # a mesh of 8 ranks is one node: everything on NVLink
    small = CountingMesh(*MESH24, rank=5, device="meta")
    assert small.my_coords == {"data": 1, "model": 1}
    small.psum(torch.empty((1, 4), device="meta"), ("data", "model"))
    assert small.link_bytes == {"nvlink": 8 * 16, "network": 0}


# ------------------------------------------------------------------ (e)
def test_roofline_prices_nvlink_and_network_bytes_at_their_rates():
    assert (ra.NVLINK_BW, ra.NET_BW) == (450e9, 50e9)
    assert ra.N_CHIPS == {"1xH100": 1, "16x16": 256, "2x16x16": 512}
    cost = {"collective_bytes": {"all-gather": 5e11, "all-reduce": 0.0},
            "collective_bytes_by_link": {"nvlink": 4.5e11,
                                         "network": 5e10}}
    assert ra.collective_time_s(cost) == pytest.approx(1.0 + 1.0)
    del cost["collective_bytes_by_link"]
    assert ra.collective_time_s(cost) == pytest.approx(5e11 / 450e9)


def test_roofline_tables_each_mesh_and_opt(tmp_path):
    d = tmp_path / "dry"
    d.mkdir()
    kw = dict(seq=256, batch=32)
    for tag, rep in (("1xH100", D.lower_cell("qwen3-1.7b", "decode_32k",
                                             **kw)),
                     ("2x16x16", D.lower_cell("qwen3-1.7b", "decode_32k",
                                              True, **kw)),
                     ("16x16_opt", D.lower_cell("qwen3-1.7b", "decode_32k",
                                                optimized=True, **kw))):
        (d / f"qwen3-1.7b_decode_32k_{tag}.json").write_text(
            json.dumps(rep))
    out, js = tmp_path / "r.md", tmp_path / "r.json"
    ra.main(["--dryrun-dir", str(d), "--out", str(out), "--json-out",
             str(js)])
    got = json.loads(js.read_text())
    assert list(got) == ["baseline", "16x16_opt", "2x16x16"]
    row = got["2x16x16"][0]
    rep = json.loads((d / "qwen3-1.7b_decode_32k_2x16x16.json").read_text())
    by = rep["cost_extrapolated"]["collective_bytes_by_link"]
    assert by["network"] > 0
    assert row["t_collective_s"] == pytest.approx(
        by["nvlink"] / ra.NVLINK_BW + by["network"] / ra.NET_BW)
    assert got["baseline"][0]["t_collective_s"] == 0
    assert "## 2x16x16 per device, rank 0 (predicted" in out.read_text()
