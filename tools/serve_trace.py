"""Where a served request's host time goes, from the port's own spans
(``repro_torch.trace``), on the serving cell of ``restore_bench``:

    python3 tools/serve_trace.py stages --seed <n> --seconds <s> \
        [--out serve_stages.json]
    python3 tools/serve_trace.py cost --seeds <a> <b> <c> --seconds <s> \
        [--out serve_trace_cost.json]

``stages`` makes one traced run of the benchmark with the program's
tracer over its window (``trace_window``): the program's spans join the
benchmark's as ``(name, t0, t1)`` before the device trace is summarised,
so an idle gap is put down to the program's stage open when it began,
and its counters join the benchmark's under their own names.  It reports
every idle gap label, not the result line's first ten, the program's
readings (``program_metrics``, ``readings``) beside the result line's
metrics, the decode step's CUDA graph (``decode_graph``: its captures
and replays over set-up and over the window, and the share of the
window's decode steps replayed), each kind of request's host time by
stage (``per_request``), and each stage's self time (its span less its
children's) in a decode step, in a prefill and in
``kvrepo.store_prefix``, averaged over the calls.  A replayed decode
step runs Python below ``lm.decode`` only for each layer's latent
decompression and attention, between the graphs, so its stage table
holds those stages and the graph's launches under ``lm.decode``.

``cost`` makes untraced runs of each seed in three arms, in turns: the
program's tracer not started (``off``), started (``all``), and started
with every other decode step recording ``lm.decode`` alone (``alt``: the
other spans of such a step cost what they cost with tracing off).  It
reports ``output_tokens_per_s`` and the host's time to issue a decode
step (a clock around ``Model.decode_step``, unsynchronised) in each arm;
in ``alt``, the two kinds of step side by side within one window, so the
host's drift between runs cancels, and from their difference the
tracer's cost a span where it runs (``tracer_cost_us_per_span``).  With
tracing on, a span's entry and exit fall in its parent's self time: the
``all`` arm's decode stage table gives each stage's self time, its child
spans a call, and its self time less their cost.

``--smoke`` runs the cell's small CPU form (``restore_bench/smoke.py``)
to rehearse either command without a card.  One JSON object goes to
``--out``; a summary goes to standard output."""
import argparse
import collections
import functools
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

from restore_bench import harness, smoke  # noqa: E402
from restore_bench import trace as bench_trace  # noqa: E402

CELL = "minicpm3.docqa"
WRAPPERS = ("serve.request", "model.prefill", "model.decode_step",
            "kv.probe", "kv.splice", "kv.store_prefix",
            "kernel.flash_attention", "no benchmark span open")


def _run(seed, seconds, traced, device, smoke_size, hooks=None):
    kw = {}
    if smoke_size:
        kw = dict(config=smoke.config(CELL), traffic=smoke.traffic(CELL))
    return harness.run_cell(CELL, seed, seconds, traced, device,
                            time.perf_counter(), hooks=hooks, **kw)


def _mean_ms(spans, name):
    ms = [(s.t1 - s.t0) / 1e6 for s in spans if s.name == name]
    return sum(ms) / len(ms) if ms else None


def merge_program_trace(rec, records) -> None:
    """The program's spans and counters into the benchmark's recorder:
    spans as ``(name, t0, t1)``, counters under their own names (none of
    either shares a name with the benchmark's)."""
    rec.spans.extend((s.name, s.t0, s.t1) for s in records.spans)
    for k, v in records.counters.items():
        rec.counters[k] += v


def trace_window(drv) -> None:
    """A ``run_cell`` hook: the program's tracer runs over the cell
    ``Driver``'s window, and what it recorded is merged into the cell's
    recorder and kept as ``drv.program_trace``; what it recorded before
    the window (set-up, where it was started then) is kept as
    ``drv.setup_trace``."""
    from repro_torch import trace
    inner = drv.window

    def window(seconds):
        drv.setup_trace = trace.stop()
        trace.start()
        try:
            return inner(seconds)
        finally:
            drv.program_trace = trace.stop()
            merge_program_trace(drv.rec, drv.program_trace)
    drv.window = window


def program_metrics(records) -> dict:
    """Readings of the program's own spans and counters: the host's time
    to issue a decode step (``lm.decode``, ms), the attention wrapper's
    path on the card (``fa.forward``, us), the greedy pick
    (``session.sample``, ms), ``KVRepository.store_prefix``
    (``kvrepo.store_prefix``, ms), and the fingerprint hashes a prompt
    token (``kv.hashed_tokens`` / ``session.prompt_tokens``); None where
    the run recorded nothing to read."""
    spans, c = records.spans, records.counters
    fa = _mean_ms(spans, "fa.forward")
    tokens = c.get("session.prompt_tokens")
    return {"decode_host_ms": _mean_ms(spans, "lm.decode"),
            "attention_host_us": None if fa is None else 1e3 * fa,
            "sample_wait_ms": _mean_ms(spans, "session.sample"),
            "store_prefix_ms": _mean_ms(spans, "kvrepo.store_prefix"),
            "hashes_per_prompt_token":
                c.get("kv.hashed_tokens", 0) / tokens if tokens else None}


def readings(records) -> dict:
    """The program's counters a call: host reads a decode step
    (``session.host_reads`` over ``lm.decode`` spans), attention launches
    a model call (``launches.flash_attention`` over ``lm.prefill`` and
    ``lm.decode`` spans), aliases a stored prompt (``kv.aliases_added``
    over ``kvrepo.store_prefix`` spans); None with nothing to divide by."""
    n = collections.Counter(s.name for s in records.spans)
    c = records.counters

    def per(key, *names):
        d = sum(n[k] for k in names)
        return c.get(key, 0) / d if d else None
    return {"host_reads_per_decode_step": per("session.host_reads",
                                              "lm.decode"),
            "attention_launches_per_call": per("launches.flash_attention",
                                               "lm.prefill", "lm.decode"),
            "aliases_per_stored_prompt": per("kv.aliases_added",
                                             "kvrepo.store_prefix")}


GRAPH_COUNTERS = ("lm.decode_graph.captures", "lm.decode_graph.replays")


def decode_graph(records, setup=None) -> dict:
    """The decode step's CUDA graph (``Model.decode_step``): its
    captures and replays in ``records``, the share of their
    ``lm.decode`` spans replayed (None without one), and, from the
    counters ``setup`` (set-up's), its captures and replays there."""
    c = records.counters
    steps = sum(1 for s in records.spans if s.name == "lm.decode")
    out = {k: c.get(k, 0) for k in GRAPH_COUNTERS}
    out["replayed_share"] = out[GRAPH_COUNTERS[1]] / steps if steps \
        else None
    if setup is not None:
        out.update({"setup." + k: setup.get(k, 0) for k in GRAPH_COUNTERS})
    return out


REQUEST_STAGES = ("session.clone", "lm.prefill", "session.sample",
                  "lm.decode", "kvrepo.store_prefix")


def per_request(spans) -> dict:
    """Requests by how their prefix came, each kind's mean host ms a
    request in each of ``REQUEST_STAGES``: a request's spans are those
    that carry its id (``trace.request``), and its kind is the tier its
    splice read (``kvstore.get.<tier>``), or ``cold`` with no splice."""
    ms = collections.defaultdict(collections.Counter)
    kind = {}
    for s in spans:
        if s.request is None:
            continue
        kind.setdefault(s.request, "cold")
        if s.name.startswith("kvstore.get."):
            kind[s.request] = s.name[len("kvstore.get."):]
        elif s.name in REQUEST_STAGES:
            ms[s.request][s.name] += (s.t1 - s.t0) / 1e6
    out = {}
    for k in sorted(set(kind.values())):
        rids = [r for r in kind if kind[r] == k]
        out[k] = {"requests": len(rids)}
        for st in REQUEST_STAGES:
            out[k][st] = sum(ms[r][st] for r in rids) / len(rids)
    return out


def _stage_table(spans, root):
    """Mean self time (ms), calls and child spans of each stage below
    the spans named ``root``, a call of ``root`` at a time."""
    from repro_torch.trace import self_ns
    own = self_ns(spans)
    kids = collections.defaultdict(list)
    for s in spans:
        kids[s.parent].append(s)
    roots = [s for s in spans if s.name == root]
    ns, calls, subs = (collections.Counter() for _ in range(3))
    for r in roots:
        todo = [r]
        while todo:
            s = todo.pop()
            ns[s.name] += own[s.id]
            calls[s.name] += 1
            subs[s.name] += len(kids[s.id])
            todo.extend(kids[s.id])
    n = max(len(roots), 1)
    rows = sorted(ns, key=lambda k: -ns[k])
    return {"calls": len(roots),
            "mean_ms": sum((r.t1 - r.t0) for r in roots) / n / 1e6,
            "stages": [[k, ns[k] / n / 1e6, calls[k] / n, subs[k] / n]
                       for k in rows]}


def less_tracer(table, us_per_span):
    """``_stage_table``'s rows with each stage's self time less
    ``us_per_span`` for every child span opened inside it: the entry and
    exit of a child fall in its parent's self time."""
    return [[k, ms, c, sub, ms - sub * us_per_span / 1e3]
            for k, ms, c, sub in table["stages"]]


def stages(a, device):
    # every idle gap's label, not the result line's first ten
    bench_trace.summarize = functools.partial(bench_trace.summarize,
                                              top=10_000)
    from repro_torch import trace
    trace.start()       # over set-up too: the decode graph's capture
    try:
        out = _run(a.seed, a.seconds, True, device, a.smoke,
                   hooks=trace_window)
    finally:
        trace.stop()
    drv = out["_driver"]
    pt = drv.program_trace
    gaps = out.get("breakdown", {}).get("idle_gaps", [])
    idle = sum(s for _, s in gaps)
    wrapped = sum(s for n, s in gaps if n in WRAPPERS)
    rep = {"seed": a.seed, "correct": out["correct"],
           "device": out["device"],
           "metrics": {k: v["value"] for k, v in out["metrics"].items()},
           "program": program_metrics(pt), "readings": readings(pt),
           "decode_graph": decode_graph(pt, drv.setup_trace.counters),
           "requests": per_request(pt.spans),
           "idle_gaps": gaps, "idle_s": idle,
           "idle_under_benchmark_spans_s": wrapped,
           "decode": _stage_table(pt.spans, "lm.decode"),
           "prefill": _stage_table(pt.spans, "lm.prefill"),
           "store_prefix": _stage_table(pt.spans, "kvrepo.store_prefix"),
           "counters": dict(pt.counters),
           "device_ops": out.get("breakdown", {}).get("device_ops", []),
           "checked": out["_checked"]}
    print(json.dumps({k: rep[k] for k in (
        "seed", "correct", "metrics", "program", "readings",
        "decode_graph", "requests", "idle_s",
        "idle_under_benchmark_spans_s")}))
    for n, s in gaps[:25]:
        print(f"idle {s:10.4f} s  {n}")
    for k in ("decode", "prefill", "store_prefix"):
        t = rep[k]
        print(f"{k}: {t['calls']} calls, {t['mean_ms']:.3f} ms each")
        for n, ms, c, sub in t["stages"]:
            print(f"  {n:24s} {ms:10.4f} ms  {c:8.1f} calls {sub:8.1f} kids")
    return rep


ARMS = ("off", "all", "alt")


def _median(xs):
    xs = sorted(x for x in xs if x is not None)
    return statistics.median(xs) if xs else None


def cost(a, device):
    import torch
    from repro_torch import trace
    full = trace.span
    runs = []
    order = []
    for i, seed in enumerate(a.seeds):
        order += [(seed, ARMS[(i + j) % 3]) for j in range(3)]
    for seed, arm in order:
        issue, every = [], []
        state = {"all": True}

        def span(name):
            if state["all"] or name == "lm.decode":
                return full(name)
            return trace._OFF

        def hooks(drv, arm=arm):
            inner = drv.model.decode_step

            def timed(*args, **kw):
                if arm == "alt":
                    state["all"] = not state["all"]
                every.append(state["all"])
                t = time.perf_counter()
                try:
                    return inner(*args, **kw)
                finally:
                    issue.append(time.perf_counter() - t)
            drv.model.decode_step = timed
            if arm != "off":
                trace.span = span
                trace.start()
        try:
            out = _run(seed, a.seconds, False, device, a.smoke, hooks=hooks)
        finally:
            trace.span = full
            rec = trace.stop()
        dec = [(s.t1 - s.t0) / 1e6 for s in rec.spans
               if s.name == "lm.decode"]
        line = {"seed": seed, "arm": arm, "correct": out["correct"],
                "output_tokens_per_s":
                    out["metrics"].get("output_tokens_per_s", {}).get("value"),
                "decode_steps": len(issue),
                "decode_issue_ms": 1e3 * statistics.fmean(issue),
                "sample_ms": _mean_ms(rec.spans, "session.sample"),
                "spans": len(rec.spans)}
        if arm == "alt":
            # lm.decode spans end in the order the steps were called
            line["steps_match_spans"] = len(dec) == len(every)
            for k, want in (("all", True), ("decode_only", False)):
                line["decode_issue_ms." + k] = 1e3 * statistics.fmean(
                    [t for t, e in zip(issue, every) if e == want])
                line["lm_decode_ms." + k] = statistics.fmean(
                    [t for t, e in zip(dec, every) if e == want])
            tab = _stage_table(rec.spans, "lm.decode")
            # the spans of a step that records them all, lm.decode's own
            # left out; tab's calls a step are over every lm.decode
            per_step = (sum(c for _, _, c, _ in tab["stages"]) - 1) \
                * tab["calls"] / max(sum(every), 1)
            line["spans_per_full_step"] = per_step
            line["tracer_cost_us_per_span"] = 1e3 * (
                line["lm_decode_ms.all"] - line["lm_decode_ms.decode_only"]
            ) / per_step
        if arm == "all":
            line["decode"] = _stage_table(rec.spans, "lm.decode")
            line["lm_decode_ms"] = statistics.fmean(dec)
        print(json.dumps({k: v for k, v in line.items() if k != "decode"}),
              flush=True)
        runs.append(line)
        del out
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    rep = {"runs": runs, "arms": {}}
    for arm in ARMS:
        got = [r for r in runs if r["arm"] == arm]
        rep["arms"][arm] = {k: _median(r.get(k) for r in got) for k in (
            "output_tokens_per_s", "decode_issue_ms", "lm_decode_ms",
            "decode_issue_ms.all", "decode_issue_ms.decode_only",
            "lm_decode_ms.all", "lm_decode_ms.decode_only",
            "tracer_cost_us_per_span")}
    c_us = rep["arms"]["alt"]["tracer_cost_us_per_span"] or 0.0
    rep["decode"] = [less_tracer(r["decode"], c_us) for r in runs
                     if r["arm"] == "all"]
    print(json.dumps(rep["arms"]))
    return rep


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("what", choices=("stages", "cost"))
    ap.add_argument("--seed", type=int, default=2**31 + 77)
    ap.add_argument("--seeds", type=int, nargs="+",
                    default=[2**31 + 78, 2**31 + 79, 2**31 + 80])
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    harness.cache_dirs()
    import torch
    if a.smoke:
        device = "cpu"
    elif torch.cuda.is_available():
        device = "cuda:0"
    else:
        print("serve_trace: needs a CUDA card (or --smoke)", file=sys.stderr)
        return 3
    rep = stages(a, device) if a.what == "stages" else cost(a, device)
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        Path(a.out).write_text(json.dumps(rep))
    return 0


if __name__ == "__main__":
    sys.exit(main())
