"""One run of one cell: set-up, the measured window, the verdict and the
result line.  ``run.py`` is the command; tests call ``run_cell`` with a
CPU device and small sizes."""
from __future__ import annotations

import importlib
import importlib.util
import json
import os
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_spec(root: Path = ROOT) -> Dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def load_json(*parts) -> Dict:
    with open(HERE.joinpath(*parts)) as f:
        return json.load(f)


def cell_entry(spec: Dict, name: str) -> Dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def e2e_metrics(spec: Dict, cell: str) -> List[Dict]:
    return [m for m in spec["end_to_end"]
            if "workloads" not in m or cell in m["workloads"]]


def layer_metrics(spec: Dict, cell: str) -> List[Dict]:
    mine = {m["name"] for m in e2e_metrics(spec, cell)}
    out = []
    for m in spec["per_layer"]:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif m["moves"] in mine:
            out.append(m)
    return out


def reader(name: str):
    """``metrics/<name>.py``'s ``read``."""
    path = HERE / "metrics" / f"{name}.py"
    mod_name = "restore_bench.metrics._" + name.replace(".", "_").replace(
        "-", "_")
    if mod_name in sys.modules:
        return sys.modules[mod_name].read
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules(modules=None) -> List[str]:
    """Loaded modules (``sys.modules`` by default) whose top-level name is
    JAX's, Flax's or the JAX package's, compared whole (``repro_torch``
    is not ``repro``)."""
    names = list(sys.modules if modules is None else modules)
    return sorted({m.split(".")[0] for m in names
                   if m.split(".")[0] in FORBIDDEN})


class Run:
    """What the metric readers read: the driver's record, spans,
    counters, recorded kernel calls, the device trace's summary and the
    config."""

    def __init__(self, record, rec, trace, config, traffic, setup_s):
        self.__dict__.update(record)
        self.spans = rec.spans
        self.counters = rec.counters
        self.calls = rec.calls
        self.trace = trace
        self.config = config
        self.traffic = traffic
        self.setup_s = setup_s


def run_cell(cell: str, seed: int, seconds: float, trace: bool, device,
             t_start: float, spec: Optional[Dict] = None,
             config: Optional[Dict] = None, traffic: Optional[Dict] = None,
             hooks=None) -> Dict:
    """Set up, measure ``seconds``, judge, and return the result line's
    object (plus ``_compared`` and ``_run`` for the caller).  ``config``
    and ``traffic`` default to the cell's files; ``hooks(driver)``, if
    given, runs after set-up (the fault tests break the program there)."""
    import torch

    from .trace import DeviceTrace, Recorder, summarize

    spec = spec or load_spec()
    if config is None:
        config = load_json("configs", cell_entry(spec, cell)["config"]
                           + ".json")
    traffic = traffic or load_json("workloads", cell + ".json")
    limits = traffic["limits"]
    device = torch.device(device)
    cuda = device.type == "cuda"
    drv_mod = importlib.import_module(
        f"restore_bench.drivers.{config['driver']}")
    rec = Recorder(bool(trace), device)
    drv = drv_mod.Driver(config, traffic, seed, device, rec)
    drv.setup()
    if hooks is not None:
        hooks(drv)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start
    dt = None
    if trace and cuda:
        dt = DeviceTrace()
        dt.start()
    t_win = time.perf_counter()
    drv.window(seconds)
    drv.drain()
    if dt is not None:
        dt.stop()
    t_drained = time.perf_counter()
    peak = int(torch.cuda.max_memory_allocated(device)) if cuda else 0
    summary = None
    if dt is not None:
        summary = summarize(dt.events(), dt.t0, dt.t1, rec.spans)
        dt = None
    t_read = time.perf_counter()
    record = drv.record()
    bad = forbidden_modules()
    drv.release()
    got = drv.verify()
    t_verify = time.perf_counter()
    compared = {k: {"value": float(got[k]), "limit": float(lim)}
                for k, lim in limits.items()}
    correct = all(v["value"] <= v["limit"] for v in compared.values()) \
        and record["failed"] == 0
    run = Run(record, rec, summary, config, traffic, setup_s)
    wanted = layer_metrics(spec, cell) if trace else e2e_metrics(spec, cell)
    metrics = {}
    for m in wanted:
        v = reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": peak}
    if summary is not None:
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
    out = {"correct": bool(correct), "attempted": int(record["attempted"]),
           "failed": int(record["failed"]), "metrics": metrics,
           "device": dev}
    if summary is not None:
        out["breakdown"] = {"device_ops": summary["device_ops"],
                            "idle_gaps": summary["idle_gaps"]}
    out["compared"] = compared
    out["_checked"] = {k: v for k, v in got.items() if k not in limits}
    out["_checked"].update(
        window_and_drain_s=t_drained - t_win, trace_read_s=t_read - t_drained,
        verify_s=t_verify - t_read, **drv.notes())
    out["_forbidden"] = bad
    out["_run"] = run
    out["_driver"] = drv
    return out


def cache_dirs(root: Path = ROOT) -> None:
    """Every build and kernel cache inside the checkout, at fixed paths
    (the port's own kernels build into ``<checkout>/build/``)."""
    b = root / "build"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(b / sub)
    os.environ["USE_FLAX"] = "0"
