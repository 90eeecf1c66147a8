"""BENCHMARK.json against its format's rules: names, units, sources,
the files each entry names, and what every cell reports."""
import json
import re
from pathlib import Path

import pytest

from restore_bench import harness

ROOT = Path(__file__).resolve().parents[1]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
WIDTH_WORDS = ("hidden", "intermediate", "latent", "state", "proj",
               "head", "expan", "experts_per_tok", "width")
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]
CELLS = [w["name"] for w in SPEC["workloads"]]


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys():
    assert sorted(SPEC) == sorted(["command", "paths", "run_seconds",
                                   "configs", "workloads", "end_to_end",
                                   "per_layer"])
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_command_and_paths():
    assert 1 <= len(SPEC["paths"]) <= 16
    for p in SPEC["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir() and not p.endswith("_torch")
    assert 1 <= len(SPEC["command"]) <= 32
    for w in SPEC["command"]:
        assert _line(w) and not w.startswith("/") and ".." not in w
        if "/" in w:
            assert any(w.startswith(p + "/") for p in SPEC["paths"])
            assert (ROOT / w).is_file()


def test_run_seconds_fit_the_check():
    rs = SPEC["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check of 24 cells: 2 + 14 runs a cell, 60 s over each run,
    # 2 x 90 s a cell to compile, 1200 s spare
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("m", METRICS, ids=[m["name"] for m in METRICS])
def test_metric_entry(m):
    allowed = {"name", "unit", "better", "source", "bound", "workloads",
               "layer", "moves"}
    assert set(m) <= allowed
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    assert m["source"] in ("device_trace", "program_span", "program_counter",
                           "host_clock")
    assert (Path(harness.HERE) / "metrics" / f"{m['name']}.py").is_file()
    for c in m.get("workloads", []):
        assert c in CELLS


@pytest.mark.parametrize("m", SPEC["end_to_end"],
                         ids=[m["name"] for m in SPEC["end_to_end"]])
def test_end_to_end_entry(m):
    assert m["source"] in ("host_clock", "device_trace")
    assert 0.01 <= m["bound"] <= 0.25
    assert "layer" not in m and "moves" not in m


@pytest.mark.parametrize("m", SPEC["per_layer"],
                         ids=[m["name"] for m in SPEC["per_layer"]])
def test_per_layer_entry(m):
    assert _line(m["layer"]) and "bound" not in m
    e2e = {e["name"]: e for e in SPEC["end_to_end"]}
    assert m["moves"] in e2e
    for c in m["workloads"]:
        assert m["moves"] in [e["name"] for e in
                              harness.e2e_metrics(SPEC, c)]
    if m["name"].endswith("_roofline") or "mfu" in m["name"]:
        assert m["unit"] == "%"


def test_names_unique():
    for group in (METRICS, SPEC["workloads"], SPEC["configs"]):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("c", SPEC["configs"],
                         ids=[c["name"] for c in SPEC["configs"]])
def test_config_entry(c):
    assert sorted(c) == ["file", "name", "reduced", "source", "why"]
    assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
    assert any(c["file"].startswith(p + "/") for p in SPEC["paths"])
    body = json.loads((ROOT / c["file"]).read_text())
    assert body["name"] == c["name"] and body["reduced"] == c["reduced"]
    assert len(c["reduced"]) <= 16
    for k in c["reduced"]:
        assert NAME.match(k)
        assert not k.endswith(("_dim", "_rank"))
        assert not any(w in k for w in WIDTH_WORDS)
    assert any(w["config"] == c["name"] for w in SPEC["workloads"])
    files = [x["file"] for x in SPEC["configs"]]
    assert files.count(c["file"]) == 1


@pytest.mark.parametrize("w", SPEC["workloads"], ids=CELLS)
def test_cell_entry(w):
    assert sorted(w) == ["chips", "config", "name", "traffic", "why"]
    assert NAME.match(w["name"]) and NAME.match(w["traffic"])
    assert _line(w["why"]) and w["chips"] in (1, 4)
    assert w["config"] in [c["name"] for c in SPEC["configs"]]
    tr = harness.load_json("workloads", w["name"] + ".json")
    assert tr["limits"]
    cfg = harness.load_json("configs", w["config"] + ".json")
    assert (Path(harness.HERE) / "drivers" / f"{cfg['driver']}.py").is_file()
    e2e = [m["name"] for m in harness.e2e_metrics(SPEC, w["name"])]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert harness.layer_metrics(SPEC, w["name"])


def test_four_chip_cells_at_most_a_quarter():
    four = sum(1 for w in SPEC["workloads"] if w["chips"] == 4)
    assert four <= max(1, len(SPEC["workloads"]) // 4)
