"""Spans and counters of the port's own stages.

The serving path records its stages here, from ``ServeSession.serve``
down to the attention kernel's launch, and its counts (prompt tokens,
fingerprint hashes, host reads, aliases) where the work happens.
Tracing is off until ``start()`` and off again after ``stop()``, which
returns what was recorded in between; the program writes nothing out.

Off, ``span`` returns one shared object whose ``__enter__`` and
``__exit__`` do nothing: no clock read, no allocation, no lock, one
check of a module global.  ``count`` and ``request`` return at once.

On, a span records ``Span(name, t0, t1, id, parent, request)``.  Times
are ``time.time_ns()``, the clock the PyTorch profiler stamps device
events with, so an idle gap on the device can be put down to the
innermost span open on the host when it began.  The parent is the span
open on the same thread (0 for none): the service's workers are
threads, each with its own stack.  ``request(rid)`` gives every span
opened inside it that request id.

Every ``LaunchCounter`` (``kernels/build.py``) registers itself here by
name; ``stop()``'s counters hold ``launches.<name>``, each counter's
launches between ``start()`` and ``stop()``; ``launch_counters()``
lists them by name.
"""
from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import Dict, List, NamedTuple, Optional


class Span(NamedTuple):
    name: str
    t0: int                  # time.time_ns() at entry
    t1: int                  # and at exit
    id: int
    parent: int              # the enclosing span on this thread, 0: none
    request: Optional[int]   # the innermost ``request(rid)``, if any


class Records(NamedTuple):
    spans: List[Span]
    counters: collections.Counter


_on = False
_spans: List[tuple] = []                # Span's fields, until stop()
_counters: collections.Counter = collections.Counter()
_lock = threading.Lock()
_ids = itertools.count(1)
_local = threading.local()
_launches: Dict[str, object] = {}      # name -> LaunchCounter
_launches0: Dict[str, int] = {}        # name -> its count at start()


class _Off:
    """The span and request scope while tracing is off."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return None


_OFF = _Off()


def _stack() -> list:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


class _Span:
    __slots__ = ("name", "t0", "id", "parent", "request", "stack")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        st = self.stack = _stack()
        self.parent = st[-1] if st else 0
        self.id = next(_ids)
        self.request = getattr(_local, "request", None)
        st.append(self.id)
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.time_ns()
        self.stack.pop()
        # a plain tuple of str, int and None: the collector stops tracking
        # it, so a window's spans add nothing to later full collections
        _spans.append((self.name, self.t0, t1, self.id, self.parent,
                       self.request))
        return None


class _Request:
    __slots__ = ("rid", "prev")

    def __init__(self, rid: int):
        self.rid = rid

    def __enter__(self):
        self.prev = getattr(_local, "request", None)
        _local.request = self.rid
        return self

    def __exit__(self, *exc):
        _local.request = self.prev
        return None


def span(name: str):
    """``with span("stage"):`` records the stage while tracing is on."""
    if not _on:
        return _OFF
    return _Span(name)


def request(rid: int):
    """``with request(rid):`` tags the spans opened inside it."""
    if not _on:
        return _OFF
    return _Request(int(rid))


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while tracing is on."""
    if not _on:
        return
    with _lock:
        _counters[name] += n


def start() -> None:
    """Turn tracing on, with no spans and every counter at 0."""
    global _on, _spans, _counters, _launches0
    with _lock:
        _spans = []
        _counters = collections.Counter()
        _launches0 = {k: c.count for k, c in _launches.items()}
        _on = True


def stop() -> Records:
    """Turn tracing off; the spans recorded since ``start()`` (in the
    order they ended) and the counters, with ``launches.<name>`` for
    every registered ``LaunchCounter``.  Nothing while tracing is off."""
    global _on, _spans, _counters
    with _lock:
        if not _on:
            return Records([], collections.Counter())
        _on = False
        spans, counters = _spans, _counters
        _spans, _counters = [], collections.Counter()
        for k, c in _launches.items():
            counters["launches." + k] = c.count - _launches0.get(k, 0)
    return Records([Span._make(s) for s in spans], counters)


def register_launches(counter) -> None:
    """Called by ``LaunchCounter.__init__``: the counter is found by its
    ``name`` from now on (a module imported again replaces its own)."""
    with _lock:
        _launches[counter.name] = counter


def launch_counters() -> Dict[str, object]:
    """Every registered ``LaunchCounter``, by name."""
    with _lock:
        return dict(_launches)


def self_ns(spans: List[Span]) -> Dict[int, int]:
    """Each span's self time: its duration less the time its children
    (the spans whose parent it is) cover, by span id."""
    own = {s.id: s.t1 - s.t0 for s in spans}
    for s in spans:
        if s.parent in own:
            own[s.parent] -= s.t1 - s.t0
    return own
