"""The frozen copies and the plain references against the port, on the
CPU at small sizes."""
import numpy as np
import pytest
import torch

from restore_bench import harness, smoke
from restore_bench.drivers import plan_spec, serve
from restore_bench.reference import minicpm3_ref, pigmix_ref
from restore_bench.yardstick import mla_weights, pigmix_tables

REC = harness.load_json("workloads", "pigmix.recurring.json")["templates"]
# parameterised plans: the generator draws their constants per workflow
PARAM = {
    "rev_by_user": {
        "plan": ["store", "rev_out", ["group_by", ["filter", ["project", [
            "load", "page_views"], ["user", "estimated_revenue"]], [
            "gt", ["col", "estimated_revenue"], ["param", "lo"]]],
            ["user"], {"total": ["sum", "estimated_revenue"]}]],
        "params": {"lo": ["uniform", 0.0, 100.0]}},
    "slow_terms": {
        "plan": ["store", "terms_out", ["group_by", ["filter", ["project", [
            "load", "page_views"], ["query_term", "timespent"]], [
            "ge", ["col", "timespent"], ["param", "t"]]],
            ["query_term"], {"n": ["count", "timespent"]}]],
        "params": {"t": ["integers", 0, 100]}},
}
N_ROWS, N_USERS, SEED = 1 << 11, 1 << 7, 2**31 + 3


def test_tables_equal_the_ports_generator():
    from repro_torch.workloads import pigmix
    mine = pigmix_tables.tables(SEED, N_ROWS, N_USERS)
    port = {"page_views": pigmix.gen_page_views(N_ROWS, SEED,
                                                n_users=N_USERS,
                                                device="cpu"),
            "users": pigmix.gen_users(SEED + 1, n_users=N_USERS,
                                      device="cpu"),
            "power_users": pigmix.gen_power_users(SEED + 2, device="cpu")}
    for name, t in port.items():
        got = t.to_numpy()
        assert sorted(got) == sorted(mine[name])
        for c in got:
            np.testing.assert_array_equal(got[c], mine[name][c])


def test_schedule_and_peaks_equal_the_ports():
    from repro_torch.roofline import analysis
    from repro_torch.workloads import stream
    from restore_bench.yardstick import peaks, stream_schedule
    cfg = stream.StreamConfig(n_events=64, n_tenants=3, zipf_s=1.1,
                              seed=SEED)
    assert stream_schedule.event_schedule(SEED, 12, 3, 1.1, 64) == \
        stream._event_schedule(cfg, 12)
    # the closed-loop streams map ranks through the same permutations:
    # at a steep Zipf every draw is rank 0, each tenant's favourite
    steep = stream.StreamConfig(n_events=64, n_tenants=3, zipf_s=60.0,
                                seed=SEED)
    fav = {t: {ti for tt, ti in stream._event_schedule(steep, 12) if tt == t}
           for t in range(3)}
    seqs = stream_schedule.tenant_streams(SEED, 12, 3, 60.0, 16)
    assert all(fav[t] == set(seqs[t]) for t in range(3)), (fav, seqs)
    assert peaks.BF16_FLOPS == analysis.PEAK_FLOPS
    assert peaks.HBM_BYTES_PER_S == analysis.HBM_BW


@pytest.mark.parametrize("name,query", [
    ("L2", "L2"), ("L3_sum", "L3"), ("L3F", "L3F"), ("L4", "L4"),
    ("L5", "L5"), ("L6", "L6"), ("L7", "L7"), ("L8", "L8"), ("L11", "L11")])
def test_templates_are_the_ports_queries(name, query):
    from repro_torch.core.plan import plan_signature
    from repro_torch.workloads import pigmix
    mine = plan_spec.lower(REC[name]["plan"], {}, {})
    assert plan_signature(mine) == plan_signature(pigmix.QUERIES[query]())


@pytest.fixture(scope="module")
def port_run():
    from repro_torch.core.repository import Repository
    from repro_torch.core.restore import ReStore
    from repro_torch.dataflow.table import Table
    from repro_torch.store.artifacts import ArtifactStore, Catalog
    tabs = pigmix_tables.tables(SEED, N_ROWS, N_USERS)
    store = ArtifactStore(device="cpu")
    cat = Catalog(store, device="cpu")
    for n, cols in tabs.items():
        cat.register(n, Table.from_numpy(cols, device="cpu"))
    rs = ReStore(cat, store, Repository(policy="cost"), heuristic="cost",
                 device="cpu")
    versions = {n: cat.version(n) for n in tabs}
    ref_tabs = {n: {c: torch.from_numpy(a) for c, a in cols.items()}
                for n, cols in tabs.items()}

    def run(node, params):
        got, _ = rs.run_plan(plan_spec.lower(node, params, versions))
        want = pigmix_ref.evaluate(node, ref_tabs, params)
        return got, want
    return run


CASES = [("rec", n) for n in sorted(REC)] + [("param", n)
                                             for n in sorted(PARAM)]


@pytest.mark.parametrize("kind,name", CASES)
def test_pigmix_reference_agrees_with_the_port(port_run, kind, name):
    t = (REC if kind == "rec" else PARAM)[name]
    rng = np.random.default_rng(7)
    params = plan_spec.draw_params(t.get("params", {}), rng)
    got, want = port_run(t["plan"], params)
    assert sorted(got) == sorted(want)
    for out, table in got.items():
        live = {c: v[table.valid] for c, v in table.columns.items()}
        r = pigmix_ref.compare(live, want[out])
        assert r["rows_wrong"] == 0
        assert r["agg_rel_err"] < 1e-5


def test_compare_sees_a_dropped_and_an_altered_row():
    t = {"k": torch.arange(6, dtype=torch.int32),
         "v": torch.linspace(1, 6, 6, dtype=torch.float32)}
    assert pigmix_ref.compare(t, {k: v.clone() for k, v in t.items()}) == \
        {"rows_wrong": 0.0, "agg_rel_err": 0.0}
    half = {k: v[:3] for k, v in t.items()}
    assert pigmix_ref.compare(half, t)["rows_wrong"] > 0
    bad = {"k": t["k"], "v": t["v"] * 1.01}
    assert pigmix_ref.compare(bad, t)["agg_rel_err"] > 5e-3


def test_minicpm3_reference_agrees_with_the_ports_smoke_model():
    from repro_torch.models.api import build
    cfg = smoke.config("minicpm3.docqa")
    w = mla_weights.make(cfg, 2**31 + 9, "cpu", torch.float32)
    drv = serve.Driver(cfg, smoke.traffic("minicpm3.docqa"), 1, "cpu", None)
    model = build(drv.program_config(), device="cpu")
    toks = torch.as_tensor(np.random.default_rng(3).integers(0, 256, 40))
    cache = model.init_cache(1, 64)
    with torch.no_grad():
        got, _ = model.prefill(w, {"tokens": toks[None],
                                   "positions": torch.arange(40)}, cache)
    want = minicpm3_ref.logits(cfg, w, [toks], [torch.tensor([39])])[0]
    assert float((got[0, -1] - want[0]).abs().max()) < 1e-4
    low = minicpm3_ref.logits(cfg, w, [toks], [torch.tensor([39])],
                              quantize=True)[0]
    assert float((low - want).abs().max()) > 1e-3


@pytest.mark.parametrize("kind", ["doc", "fresh"])
def test_serving_schedule_is_fixed_by_the_traffic_file(kind):
    tr = dict(smoke.traffic("minicpm3.docqa"), kind=kind,
              prompt_tokens=[16, 64])
    reqs, setup = serve.schedule(tr, 40)
    assert (reqs, setup) == serve.schedule(tr, 40) and len(reqs) == 40
    lo, hi = tr["doc_tokens"] if kind == "doc" else tr["prompt_tokens"]
    for r in reqs:
        n = r["doc_len"] if kind == "doc" else r["q_len"]
        assert lo <= n <= hi
        assert tr["answer_tokens"][0] <= r["answer"] <= \
            tr["answer_tokens"][1]
    if kind == "doc":
        # each live document is asked at most asks_per_doc times
        from collections import Counter
        asks = Counter(r["doc"] for r in reqs)
        assert max(asks.values()) <= tr["asks_per_doc"][1]
        assert len(setup) == tr["live_docs"]
