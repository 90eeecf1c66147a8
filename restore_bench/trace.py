"""Spans, counters and the device trace of one run, recorded from the
benchmark's own files around the calls into each layer of the program.

Spans carry host times from ``time.time_ns()``, the clock the PyTorch
profiler stamps its events with, so an idle gap on the device can be
labelled by the span that was open on the host.  Wrappers are
installed on the program's objects for a run and taken off after it."""
from __future__ import annotations

import collections
import heapq
import threading
import time
from contextlib import contextmanager
from typing import Dict, List

import numpy as np


class Recorder:
    def __init__(self, traced: bool, device=None):
        self.traced = traced
        self.device = device
        self.spans: List[tuple] = []        # (name, t0_ns, t1_ns)
        self.counters: Dict[str, float] = collections.Counter()
        self.calls: Dict[str, list] = collections.defaultdict(list)
        self._undo: List[tuple] = []
        self._lock = threading.Lock()

    def _sync(self):
        if self.device is not None and self.device.type == "cuda":
            import torch
            torch.cuda.synchronize(self.device)

    @contextmanager
    def span(self, name: str, sync: bool = False):
        t0 = time.time_ns()
        try:
            yield
        finally:
            if sync:
                self._sync()
            t1 = time.time_ns()
            with self._lock:
                self.spans.append((name, t0, t1))

    def wrap(self, obj, attr: str, name: str, sync: bool = False,
             on_call=None):
        """Replace ``obj.attr`` with a version that records a span (and,
        if given, calls ``on_call(*args, **kw)`` first), until
        ``unwrap``."""
        inner = getattr(obj, attr)
        had = attr in getattr(obj, "__dict__", {})

        def wrapper(*args, **kw):
            if on_call is not None:
                on_call(*args, **kw)
            with self.span(name, sync=sync):
                return inner(*args, **kw)
        setattr(obj, attr, wrapper)
        self._undo.append((obj, attr, inner, had))
        return wrapper

    def patch(self, obj, attr: str, new):
        """Set ``obj.attr`` to ``new`` until ``unwrap``."""
        had = attr in getattr(obj, "__dict__", {})
        self._undo.append((obj, attr, getattr(obj, attr), had))
        setattr(obj, attr, new)

    def unwrap(self):
        while self._undo:
            obj, attr, inner, had = self._undo.pop()
            if had:
                setattr(obj, attr, inner)
            else:
                delattr(obj, attr)


class DeviceTrace:
    """The profiler over a window: device activity only (kernels,
    copies, sets), read once it stops."""

    def __init__(self):
        self.prof = None
        self.t0 = self.t1 = 0

    def start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        torch.cuda.synchronize()
        self.t0 = time.time_ns()

    def stop(self):
        import torch
        torch.cuda.synchronize()
        self.t1 = time.time_ns()
        self.prof.stop()

    def events(self):
        """(name, start_ns, end_ns) of every device event in the window."""
        out = []
        res = self.prof.profiler.kineto_results
        for e in res.events():
            if str(e.device_type()).endswith("CUDA"):
                s = e.start_ns()
                out.append((e.name(), s, s + e.duration_ns()))
        return out


def summarize(events, t0: int, t1: int, spans, top: int = 10) -> Dict:
    """busy_s (union of device activity inside [t0, t1]), window_s,
    seconds by device operation, and idle gaps summed by the innermost
    benchmark span open on the host when each gap began."""
    window_s = (t1 - t0) / 1e9
    if not events:
        return {"busy_s": 0.0, "window_s": window_s, "device_ops": [],
                "idle_gaps": [], "by_name": {}}
    st = np.array([max(s, t0) for _, s, _ in events], np.int64)
    en = np.array([min(e, t1) for _, _, e in events], np.int64)
    keep = en > st
    st, en = st[keep], en[keep]
    names = [n for (n, _, _), k in zip(events, keep) if k]
    by_name: Dict[str, float] = collections.defaultdict(float)
    for n, a, b in zip(names, st, en):
        by_name[n] += (b - a) / 1e9
    order = np.argsort(st, kind="stable")
    st, en = st[order], en[order]
    # merge into busy intervals
    reach = np.maximum.accumulate(en)
    new = np.ones(len(st), bool)
    new[1:] = st[1:] > reach[:-1]
    starts = st[new]
    idx = np.flatnonzero(new)
    ends = np.append(reach[idx[1:] - 1], reach[-1])
    busy_s = float((ends - starts).sum()) / 1e9
    gap_lo = np.concatenate([[t0], ends])
    gap_hi = np.concatenate([starts, [t1]])
    gkeep = gap_hi > gap_lo
    gap_lo, gap_hi = gap_lo[gkeep], gap_hi[gkeep]
    labels: Dict[str, float] = collections.defaultdict(float)
    sp = sorted(spans, key=lambda s: s[1])
    heap: list = []
    j = 0
    for a, b in zip(gap_lo.tolist(), gap_hi.tolist()):
        while j < len(sp) and sp[j][1] <= a:
            heapq.heappush(heap, (-sp[j][1], sp[j][2], sp[j][0]))
            j += 1
        while heap and heap[0][1] < a:
            heapq.heappop(heap)
        label = heap[0][2] if heap else "no benchmark span open"
        labels[label] += (b - a) / 1e9
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(labels.items(), key=lambda kv: -kv[1])[:top]
    return {"busy_s": busy_s, "window_s": window_s,
            "device_ops": [[n[:160], s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in gaps], "by_name": dict(by_name)}
