"""A/B timing for the kernels' ``bench.py`` scripts: another checkout's
package loaded beside this one, CUDA-event timing, and turns in ABBA
order.  Imports nothing at module level beyond the standard library."""
from __future__ import annotations

import importlib
import importlib.util
import os
import statistics
import subprocess
import sys


def load_other(src_dir: str, module: str, alias: str = "repro_torch_other"):
    """``repro_torch.<module>`` of the checkout whose ``src`` directory is
    ``src_dir``, imported as ``<alias>.<module>``.  Its kernels build from
    its own ``csrc`` into its own checkout's ``build/``."""
    pkg = os.path.join(os.path.abspath(src_dir), "repro_torch")
    if alias not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            alias, os.path.join(pkg, "__init__.py"),
            submodule_search_locations=[pkg])
        mod = importlib.util.module_from_spec(spec)
        sys.modules[alias] = mod
        spec.loader.exec_module(mod)
    return importlib.import_module(f"{alias}.{module}")


def events_ms(fn, iters: int = 20) -> float:
    """Device time per call: CUDA events around ``iters`` calls, after two
    warm-up calls."""
    import torch
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def abba(variants: dict, rounds: int) -> dict:
    """Each round times every variant forward, then backward (A B B A for
    two), so drift over the call falls on all alike.  Returns the summary
    of each variant's 2 * rounds timings."""
    names = list(variants)
    times = {k: [] for k in names}
    for _ in range(rounds):
        for k in names + names[::-1]:
            times[k].append(events_ms(variants[k]))
    return {k: summary(v) for k, v in times.items()}


def summary(xs) -> dict:
    q1, med, q3 = statistics.quantiles(xs, n=4, method="inclusive")
    return dict(median=med, q1=q1, q3=q3, runs=len(xs))


def card() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
