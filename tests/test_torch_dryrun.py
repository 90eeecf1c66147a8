"""The port's dry-run and roofline (``models/api.py``'s SHAPES,
``shape_applicable``, ``init_shapes`` and ``input_specs``;
``roofline/analysis.py``; ``launch/dryrun_dataflow.py``;
``kernels/autotune.py::scatter_tile_price``) against the reference on the
CPU; ``launch/dryrun.py``'s counts are in ``test_torch_dryrun_counts.py``.

The model's trees are held to the reference's exactly: every path, shape
and dtype, meta tensors against ``jax.eval_shape``.  The roofline is held
to the reference's rows, dominant terms and markdown exactly on the same
report dicts once the reference's constants (TPU v5e peaks, its meshes,
its suggestion texts) are patched in.  The dataflow dry-run's groups are
the single-device group-by's (revenue sums within rtol 1e-5: the shards
add in another order).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import api as ref_api  # noqa: E402
from repro.roofline import analysis as ref_ra  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.dataflow.physical import op_groupby  # noqa: E402
from repro_torch.kernels import autotune  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import dryrun_dataflow as DD  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.roofline import analysis as ra  # noqa: E402
from repro_torch.tree import tree_leaves_with_path  # noqa: E402


def _ref_tree(tree):
    def key(k):
        return str(getattr(k, "key", getattr(k, "idx", k)))
    return sorted(("/".join(key(k) for k in path), tuple(v.shape),
                   str(v.dtype))
                  for path, v in jax.tree_util.tree_leaves_with_path(tree))


def _port_tree(tree):
    out = []
    for path, v in tree_leaves_with_path(tree):
        assert v.device.type == "meta", path
        out.append(("/".join(map(str, path)), tuple(v.shape),
                    str(v.dtype).replace("torch.", "")))
    return sorted(out)


# ------------------------------------------------------------ models/api


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_shapes_and_applicability_match_reference(arch):
    assert api.SHAPES == ref_api.SHAPES
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    for shape in api.SHAPES:
        assert api.shape_applicable(cfg, shape) == \
            ref_api.shape_applicable(rcfg, shape)
    assert api.shape_applicable(cfg, "long_500k")[0] == (
        arch in ("jamba-1.5-large-398b", "xlstm-350m"))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_init_shapes_and_input_specs_match_reference(arch):
    """Every architecture at its full config: the parameter tree, and
    for every applicable shape the inputs, caches included."""
    rm = ref_api.build(ref_get_config(arch))
    pm = api.build(get_config(arch), device="cpu")
    assert _port_tree(pm.init_shapes()) == \
        _ref_tree(rm.init_shapes(jax.random.PRNGKey(0)))
    for shape in api.SHAPES:
        if api.shape_applicable(pm.cfg, shape)[0]:
            assert _port_tree(pm.input_specs(shape)) == \
                _ref_tree(rm.input_specs(shape)), shape


def test_meta_init_keeps_the_real_values():
    """The meta generator changes where tensors are made, not the
    numbers a real device gets."""
    m = api.build(get_config("jamba-1.5-large-398b", smoke=True),
                  device="cpu")
    a, b = m.init(5), m.init(5)
    for (pa, x), (pb, y) in zip(tree_leaves_with_path(a),
                                tree_leaves_with_path(b)):
        assert pa == pb and x.device.type == "cpu" and torch.equal(x, y)
    assert all(v.device.type == "meta"
               for _, v in tree_leaves_with_path(m.init_shapes(5)))


# ------------------------------------------------------- roofline/analysis


def _reports():
    """Report dicts as the reference's dry-run writes them: a cell of
    each dominant term, an extrapolation gone negative, and a skip."""
    def rep(arch, shape, flops, nbytes, coll, kind, seq, gbs, n):
        return {"arch": arch, "shape": shape, "mesh": "16x16",
                "status": "ok", "kind": kind, "seq": seq,
                "global_batch": gbs, "active_params": n,
                "total_params": 2 * n, "memory": {"temp_size_in_bytes": 7},
                "cost_extrapolated": {
                    "flops": flops, "bytes": nbytes,
                    "collective_bytes": {"all-gather": coll,
                                         "all-reduce": coll / 2}}}
    return [rep("a", "train_4k", 3e15, 1e11, 1e9, "train", 4096, 256, 2e9),
            rep("b", "decode_32k", 1e11, 5e12, 1e8, "decode", 32768, 128,
                7e9),
            rep("c", "prefill_32k", 1e14, 1e11, 4e12, "prefill", 32768, 32,
                4e8),
            rep("d", "train_4k", -5.0, 1e10, -3.0, "train", 4096, 256, 1e6),
            {"arch": "e", "shape": "long_500k", "mesh": "16x16",
             "status": "skipped", "reason": "pure full-attention"}]


def test_roofline_matches_reference_with_its_constants(monkeypatch):
    for name, value in (("PEAK_FLOPS", ref_ra.PEAK_FLOPS),
                        ("HBM_BW", ref_ra.HBM_BW),
                        ("NVLINK_BW", ref_ra.ICI_BW),
                        ("N_CHIPS", ref_ra.N_CHIPS),
                        ("_SUGGESTIONS", ref_ra._SUGGESTIONS)):
        monkeypatch.setattr(ra, name, value)
    reps = _reports()
    rows, ref_rows = [], []
    for r in reps:
        got, want = ra.analyze_cell(dict(r)), ref_ra.analyze_cell(dict(r))
        assert repr(got) == repr(want)         # nan where no FLOP counts
        assert (got is None) == (r["status"] != "ok")
        if got:
            rows.append(got)
            ref_rows.append(want)
            assert ra.suggestion(got) == ref_ra.suggestion(want)
    assert [r["dominant"] for r in rows] == \
        ["compute", "memory", "collective", "memory"]
    skipped = [r for r in reps if r["status"] == "skipped"]
    assert ra.to_markdown(rows, skipped) == \
        ref_ra.to_markdown(ref_rows, skipped)
    for x in (3.0, 2e-3, 4e-6):
        assert ra.fmt_s(x) == ref_ra.fmt_s(x)


def test_model_flops_is_the_reference_formula():
    for r in _reports()[:4]:
        n, kind = r["active_params"], r["kind"]
        tokens = r["global_batch"] * (1 if kind == "decode" else r["seq"])
        want = (6.0 if kind == "train" else 2.0) * n * tokens
        assert ra.model_flops(r) == want == ref_ra.model_flops(r)


def test_compute_term_prices_each_dtype_at_its_rate():
    """H100 constants: float32 products at 67 TFLOP/s, bf16 at 989; the
    three-term bound of a tile as the reference prices it."""
    assert (ra.PEAK_FLOPS, ra.HBM_BW) == (989e12, 3.35e12)
    cost = {"flops": 2e15, "flops_by_dtype": {"bfloat16": 1e15,
                                              "float32": 1e15}}
    assert ra.compute_time_s(cost) == pytest.approx(1e15 / 989e12
                                                    + 1e15 / 67e12)
    assert ra.compute_time_s({"flops": 989e12}) == pytest.approx(1.0)
    assert ra.predict_tile_time_s(3.35e12, 0.0, 0.0, 0.5) == \
        pytest.approx(1.5)


def test_load_reports_and_main_write_the_table(tmp_path):
    import json
    d = tmp_path / "dry"
    d.mkdir()
    rep = D.lower_cell("xlstm-350m", "long_500k")
    for r in (rep, D.lower_cell("qwen3-1.7b", "long_500k")):
        (d / f"{r['arch']}_{r['shape']}_{r['mesh']}.json").write_text(
            json.dumps(r))
    out, js = tmp_path / "r.md", tmp_path / "r.json"
    ra.main(["--dryrun-dir", str(d), "--out", str(out), "--json-out",
             str(js)])
    rows = json.loads(js.read_text())["baseline"]
    assert [(r["arch"], r["mesh"]) for r in rows] == [("xlstm-350m",
                                                       "1xH100")]
    text = out.read_text()
    assert "| xlstm-350m | long_500k |" in text
    assert "`qwen3-1.7b x long_500k` (1xH100)" in text


def test_scatter_tile_price_monotone_dispatch_tradeoff():
    """The twin of ``test_autotune.py``'s: the price penalises tiny
    tiles (dispatch-bound) and keeps the working-set term finite."""
    price = autotune.scatter_tile_price(1 << 16, 8)
    costs = {t: price(t) for t in (64, 256, 1024, 4096)}
    assert all(c > 0 for c in costs.values())
    assert costs[64] > costs[4096], "dispatch overhead dominates tiny tiles"


# ---------------------------------------------------- launch/dryrun_dataflow


def test_dataflow_dryrun_reports_the_exchange_on_the_cpu():
    """2**12 rows over LocalMesh(8) on the CPU: the exchange's buffer is
    8 x 8 buckets of packed rows (20-byte key, f32 val, the 4-byte hash
    lane, the validity byte), the groups are the single-device
    group-by's, and no kernel launches off the card."""
    n = 1 << 12
    table = DD.groupby_table(n, 0, "cpu")
    grouped, rep = DD.run(table)
    bucket = min(n // 8, max(8, int(n // 8 * DD.SKEW / 8)))
    want_bytes = 64 * bucket * (20 + 4 + 4 + 1)
    assert rep["collective_bytes"]["all-to-all"] == want_bytes * (
        1 + 2 * rep["retried_lossless"])
    assert rep["memory"]["peak_bytes"] is None and rep["device"] == "cpu"
    assert set(rep["launches"].values()) == {0}

    def groups(t):
        d = t.to_numpy()
        order = np.lexsort(d["key"].T[::-1])
        return {c: d[c][order] for c in d}
    got, want = groups(grouped), groups(op_groupby(table, DD.KEYS, DD.AGGS))
    assert rep["groups"] == len(want["key"])
    np.testing.assert_array_equal(got["key"], want["key"])
    np.testing.assert_array_equal(got["cnt"], want["cnt"])
    np.testing.assert_allclose(got["total"], want["total"], rtol=1e-5)


def test_dataflow_dryrun_cli_refuses_multi_pod(tmp_path):
    """``--multi-pod`` (once refused) runs the group-by over the
    2x16x16 production mesh's DP axes, 32 logical shards, and names the
    mesh as the reference does; its groups are the single-device
    group-by's."""
    import json
    out = tmp_path / "dd.json"
    DD.main(["--multi-pod", "--device", "cpu", "--rows", "4096",
             "--out", str(out)])
    rep = json.loads(out.read_text())
    assert rep["mesh"] == "2x16x16" and rep["shards"] == 32
    assert DD.production_shards(False) == (16, "16x16")
    table = DD.groupby_table(4096, 0, "cpu")
    grouped, _ = DD.run(table, *DD.production_shards(True))
    assert rep["groups"] == int(grouped.num_valid()) == len(np.unique(
        table.to_numpy()["key"], axis=0))
