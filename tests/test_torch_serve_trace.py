"""``tools/serve_trace.py`` against the benchmark's serving cell on the
CPU: the program's span names are not the benchmark's, merging the
program's records into a run changes no reading of the benchmark's own
per-layer metrics, the program's readings read their spans and counters
(None without them), and a traced run with the program's tracer over
its window labels the benchmark's records with the program's stages."""
import collections
import importlib.util
import re
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from restore_bench import harness, smoke  # noqa: E402
from restore_bench.drivers import serve  # noqa: E402
from restore_bench.trace import Recorder  # noqa: E402

SRC = ROOT / "src" / "repro_torch"
_spec = importlib.util.spec_from_file_location(
    "serve_trace", ROOT / "tools" / "serve_trace.py")
st = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(st)

WRAPPERS = {"serve.request", "model.prefill", "model.decode_step",
            "kv.probe", "kv.splice", "kv.store_prefix",
            "kernel.flash_attention"}
BENCH = ["prefix_reused_frac", "ttft_p95_s.docqa", "splice_ms",
         "prefill_ms_per_ktok", "decode_step_ms",
         "flash_attention_roofline", "serve_mfu", "idle_frac.serve"]
SPANS = {"decode_host_ms": ("lm.decode", 1.0),
         "attention_host_us": ("fa.forward", 1e3),
         "sample_wait_ms": ("session.sample", 1.0),
         "store_prefix_ms": ("kvrepo.store_prefix", 1.0)}
Span = collections.namedtuple("Span", "name t0 t1 id parent request")
Records = collections.namedtuple("Records", "spans counters")


def _program_span_names():
    pat = re.compile(r"""trace\.span\(\s*["']([^"']+)["']""")
    names = set()
    for path in SRC.rglob("*.py"):
        names |= set(pat.findall(path.read_text()))
    return names


def test_program_span_names_are_not_the_benchmarks():
    names = _program_span_names()
    for want in ("session.sample", "session.clone", "lm.decode",
                 "lm.sublayer", "mla.expand", "fa.forward",
                 "kvrepo.store_prefix", "kvstore.get.device"):
        assert want in names
    assert not names & WRAPPERS
    text = Path(serve.__file__).read_text()
    # a wrapper's name is the last string among rec.wrap's arguments
    used = {re.findall(r"""["']([^"']+)["']""", args)[-1]
            for args in re.findall(r"rec\.wrap\(([^)]*)\)", text)}
    used |= set(re.findall(r"""rec\.span\(\s*["']([^"']+)["']""", text))
    assert used == WRAPPERS


def _fake(program: bool):
    """A fixed traced run of the serving cell: the benchmark's spans,
    counters, calls and trace summary, with or without a program's
    records merged in."""
    rec = Recorder(True)
    ms = 1_000_000
    t = 0
    for i in range(6):
        rec.spans.append(("serve.request", t, t + 900 * ms))
        rec.spans.append(("kv.probe", t, t + 2 * ms))
        rec.spans.append(("model.prefill", t + 5 * ms, t + 305 * ms))
        for j in range(4):
            a = t + (320 + 150 * j) * ms
            rec.spans.append(("model.decode_step", a, a + (140 + i) * ms))
        rec.spans.append(("kv.splice", t + 3 * ms, t + 4 * ms))
        t += 1000 * ms
    rec.counters["prefill_tokens"] += 5000
    rec.counters["prefill_calls"] += 6
    rec.calls["flash_attention"] = [
        (1, 40, 40, 1, 96, 64, 4000 + k, 3999 + k, True, 2)
        for k in range(24)]
    if program:
        names = {"model.decode_step": "lm.decode",
                 "model.prefill": "lm.prefill"}
        spans = [Span(names[n], a + 1000, b - 1000, i + 1, 0, 1)
                 for i, (n, a, b) in enumerate(list(rec.spans))
                 if n in names]
        counters = collections.Counter({"kv.hashed_tokens": 9000,
                                        "session.prompt_tokens": 4500,
                                        "launches.flash_attention": 24})
        st.merge_program_trace(rec, Records(spans, counters))
    record = dict(
        events=[dict(start=0.0, first=0.3 + i / 10, done=1.0, reused=4000,
                     prefilled=500) for i in range(6)],
        marks=[0.1 * i for i in range(60)], t_end=5.5, window_s=6.0)
    summary = {"busy_s": 1.25, "window_s": 6.0,
               "by_name": {"fa_sm90_kernel_x": 0.05,
                           "fa_merge_kernel_y": 0.01, "gemm": 1.0}}
    config = harness.load_json("configs", "minicpm3-4b.json")
    return harness.Run(record, rec, summary, config, {}, 12.0)


@pytest.mark.parametrize("name", BENCH)
def test_merging_program_records_moves_no_benchmark_reader(name):
    plain, merged = _fake(False), _fake(True)
    assert len(merged.spans) == len(plain.spans) + 6 * 5
    read = harness.reader(name)
    assert read(plain) is not None
    assert read(plain) == read(merged)


@pytest.mark.parametrize("name", sorted(SPANS))
def test_program_readings_read_their_span(name):
    span, scale = SPANS[name]
    assert st.program_metrics(Records([], collections.Counter()))[name] \
        is None
    spans = [Span(span, 0, 2_000_000, 1, 0, None),
             Span(span, 10, 4_000_010, 2, 0, None),
             Span("lm.sublayer", 0, 9_000_000, 3, 0, None)]
    got = st.program_metrics(Records(spans, collections.Counter()))
    assert got[name] == pytest.approx(3.0 * scale)


def test_hash_reading_reads_its_counters():
    c = collections.Counter()
    assert st.program_metrics(Records([], c))["hashes_per_prompt_token"] \
        is None
    c["kv.hashed_tokens"] += 900
    c["session.prompt_tokens"] += 450
    assert st.program_metrics(Records([], c))["hashes_per_prompt_token"] \
        == pytest.approx(2.0)


def test_traced_run_with_the_program_tracer_labels_its_stages():
    out = smoke.run("minicpm3.docqa", trace=True, hooks=st.trace_window)
    assert out["correct"], out["compared"]
    drv = out["_driver"]
    got = st.program_metrics(drv.program_trace)
    # the CPU takes the plain attention: no fa.forward span
    assert got["attention_host_us"] is None
    for name in ("decode_host_ms", "sample_wait_ms", "store_prefix_ms"):
        assert got[name] > 0, name
    assert 1.0 <= got["hashes_per_prompt_token"] <= 2.0
    # the synchronised benchmark span holds the unsynchronised program one
    assert got["decode_host_ms"] <= out["metrics"]["decode_step_ms"]["value"]
    run = out["_run"]
    labels = collections.Counter(n for n, _, _ in run.spans)
    assert labels["lm.decode"] == labels["model.decode_step"] > 0
    assert run.counters["session.prompt_tokens"] > 0
    for name in BENCH[:5]:
        assert name in out["metrics"]


def test_readings_divide_the_counters_by_their_calls():
    assert set(st.readings(Records([], collections.Counter())).values()) \
        == {None}
    spans = ([Span("lm.decode", 0, 1, i, 0, None) for i in range(4)]
             + [Span("lm.prefill", 0, 1, 9, 0, None),
                Span("kvrepo.store_prefix", 0, 1, 10, 0, None)])
    c = collections.Counter({"session.host_reads": 5,
                             "launches.flash_attention": 310,
                             "kv.aliases_added": 75})
    assert st.readings(Records(spans, c)) == {
        "host_reads_per_decode_step": 1.25,
        "attention_launches_per_call": 62.0,
        "aliases_per_stored_prompt": 75.0}


def test_per_request_groups_spans_by_request_and_splice_tier():
    ms = 1_000_000
    spans = [Span("lm.prefill", 0, 300 * ms, 1, 0, 0),
             Span("lm.decode", 0, 100 * ms, 2, 0, 0),
             Span("kvrepo.store_prefix", 0, 90 * ms, 3, 0, 0),
             Span("kvstore.put", 0, 4 * ms, 4, 3, 0),
             Span("kvstore.get.device", 0, 1, 5, 0, 1),
             Span("session.clone", 0, 2 * ms, 6, 0, 1),
             Span("lm.prefill", 0, 20 * ms, 7, 0, 1),
             Span("lm.prefill", 0, 40 * ms, 8, 0, 2),
             Span("kvstore.get.device", 0, 1, 9, 0, 2),
             Span("lm.decode", 0, 1 * ms, 10, 0, None)]
    got = st.per_request(spans)
    assert sorted(got) == ["cold", "device"]
    assert got["cold"]["requests"] == 1
    assert got["cold"]["lm.prefill"] == pytest.approx(300.0)
    assert got["cold"]["lm.decode"] == pytest.approx(100.0)
    assert got["cold"]["kvrepo.store_prefix"] == pytest.approx(90.0)
    assert got["device"]["requests"] == 2
    assert got["device"]["lm.prefill"] == pytest.approx(30.0)
    assert got["device"]["session.clone"] == pytest.approx(1.0)
    assert got["device"]["lm.decode"] == 0


def test_stage_table_counts_child_spans_and_takes_their_cost_off():
    us = 1_000
    spans = [Span("lm.decode", 0, 1000 * us, 1, 0, None),
             Span("lm.sublayer", 100 * us, 900 * us, 2, 1, None),
             Span("mla.project", 200 * us, 300 * us, 3, 2, None),
             Span("lm.ffn", 400 * us, 500 * us, 4, 2, None)]
    tab = st._stage_table(spans, "lm.decode")
    rows = {r[0]: r for r in st.less_tracer(tab, 10.0)}
    assert tab["calls"] == 1 and tab["mean_ms"] == pytest.approx(1.0)
    assert rows["lm.sublayer"][1:] == pytest.approx([0.6, 1, 2, 0.58])
    assert rows["lm.decode"][1:] == pytest.approx([0.2, 1, 1, 0.19])
    assert rows["lm.ffn"][1:] == pytest.approx([0.1, 1, 0, 0.1])


def test_cost_runs_its_three_arms_on_the_cpu():
    import argparse
    a = argparse.Namespace(seeds=[2**31 + 11], seconds=0.3, smoke=True)
    rep = st.cost(a, "cpu")
    runs = {r["arm"]: r for r in rep["runs"]}
    assert sorted(runs) == sorted(st.ARMS)
    assert all(r["correct"] for r in rep["runs"])
    assert runs["off"]["spans"] == 0
    alt = runs["alt"]
    assert alt["steps_match_spans"] and alt["decode_steps"] >= 2
    # a full step records lm.decode and every stage below it
    assert alt["spans_per_full_step"] >= 4
    assert rep["decode"] and rep["decode"][0][0][0] in (
        "mla.project", "lm.sublayer", "mla.expand", "lm.ffn", "lm.decode",
        "mla.attend", "mla.out", "mla.cache_write", "lm.unembed")
    from repro_torch import trace
    assert trace.span("x") is trace._OFF
