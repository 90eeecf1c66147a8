"""Arithmetic the readers share."""
from __future__ import annotations

import numpy as np


def p95(values):
    return float(np.percentile(np.asarray(values, float), 95)) \
        if len(values) else None


def idle_pct(run):
    t = run.trace
    if t is None or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def device_s(run, parts):
    """Device seconds of the trace's operations whose name holds any of
    ``parts``."""
    if run.trace is None:
        return 0.0
    return sum(s for n, s in run.trace["by_name"].items()
               if any(p in n for p in parts))


def roofline_pct(run, key, parts, bound):
    calls = run.calls.get(key, [])
    t = device_s(run, parts)
    if not calls or t <= 0:
        return None
    return 100.0 * sum(bound(*c) for c in calls) / t


def span_mean_ms(run, name):
    ms = [(t1 - t0) / 1e6 for n, t0, t1 in run.spans if n == name]
    return float(np.mean(ms)) if ms else None
