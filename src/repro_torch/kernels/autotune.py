"""Autotuner for exchange/kernel configuration knobs (DESIGN.md §14).

Two halves:

* **TuningTable** — a persisted JSON map from ``op|rows-bucket|dtype``
  keys to ``{param: value}`` choices.  Rows are bucketed to the next
  power of two so one tuning run covers a whole size class.  Loading a
  missing or corrupt table yields an empty one (graceful fallback to
  defaults), and save -> load round-trips bit-exactly.

* **tune()** — pick a value for one parameter: a caller-supplied
  roofline price function (``roofline.analysis.predict_tile_time_s``
  underneath) prunes the candidate grid to the ``top_k`` cheapest
  predictions, then an injectable ``measure`` callback times those few
  for real and the median-fastest wins.  Ties break toward the earlier
  candidate, so selection is deterministic under a deterministic
  measurement stub.

Runtime consumers call :func:`choose`, which returns the caller's
default unless tuning is enabled (``RESTORE_AUTOTUNE=1``) AND the table
has an entry — so the tuner is inert by default and dropping the table
file merely reverts every knob to its built-in default.  Tuned knobs:

* ``("join_probe", rows, "uint32") / "slack"`` — the JOIN probe
  window's slack beyond the expansion (dataflow/physical.py).
* ``("exchange", 0, "row") / "skew"`` — the exchange's per-destination
  bucket skew factor; rows=0 is the global size class (the executor
  does not know the input size at engine construction).
"""
from __future__ import annotations

import json
import os
import statistics
from typing import Callable, Dict, Optional, Sequence

DEFAULT_TABLE_ENV = "RESTORE_AUTOTUNE_TABLE"
ENABLE_ENV = "RESTORE_AUTOTUNE"
DEFAULT_TABLE_PATH = os.path.join(
    os.path.expanduser("~"), ".cache", "restore_tuning.json")


def rows_bucket(rows: int) -> int:
    """Next power of two >= rows (0 stays 0: the global size class)."""
    rows = int(rows)
    return 1 << (rows - 1).bit_length() if rows > 0 else 0


class TuningTable:
    """``{key: {param: value}}`` with JSON persistence."""

    def __init__(self, entries: Optional[Dict[str, Dict]] = None):
        self.entries: Dict[str, Dict] = dict(entries or {})

    @staticmethod
    def key(op: str, rows: int, dtype: str) -> str:
        return f"{op}|{rows_bucket(rows)}|{dtype}"

    def get(self, op: str, rows: int, dtype: str, param: str,
            default=None):
        ent = self.entries.get(self.key(op, rows, dtype))
        if ent is None:
            return default
        return ent.get(param, default)

    def put(self, op: str, rows: int, dtype: str, param: str,
            value) -> None:
        self.entries.setdefault(self.key(op, rows, dtype), {})[param] = value

    def save(self, path: str) -> None:
        tmp = path + ".tmp"
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(tmp, "w") as f:
            json.dump(self.entries, f, indent=1, sort_keys=True)
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str) -> "TuningTable":
        try:
            with open(path) as f:
                data = json.load(f)
            if not isinstance(data, dict):
                raise ValueError("tuning table root must be an object")
            return cls({k: dict(v) for k, v in data.items()
                        if isinstance(v, dict)})
        except (OSError, ValueError):
            return cls()


def enabled() -> bool:
    return os.environ.get(ENABLE_ENV, "") not in ("", "0")


def table_path() -> str:
    return os.environ.get(DEFAULT_TABLE_ENV, DEFAULT_TABLE_PATH)


_cache: Dict[str, TuningTable] = {}


def get_table(refresh: bool = False) -> TuningTable:
    path = table_path()
    if refresh or path not in _cache:
        _cache[path] = TuningTable.load(path)
    return _cache[path]


def choose(op: str, rows: int, dtype: str, param: str, default):
    """The runtime hook: tuned value if tuning is on and the table has
    one, the caller's default otherwise.  The returned value is coerced
    to the default's type so a hand-edited table cannot change a knob's
    kind (e.g. float skew vs int tile)."""
    if not enabled():
        return default
    v = get_table().get(op, rows, dtype, param, default)
    try:
        return type(default)(v)
    except (TypeError, ValueError):
        return default


def tune(op: str, rows: int, dtype: str, param: str,
         candidates: Sequence, measure: Callable[[object], float], *,
         table: Optional[TuningTable] = None,
         price: Optional[Callable[[object], float]] = None,
         top_k: int = 3, reps: int = 3):
    """Select a value for ``param`` and record it in ``table``.

    ``price(candidate) -> predicted seconds`` (roofline) prunes to the
    ``top_k`` cheapest candidates; ``measure(candidate) -> seconds`` is
    then run ``reps`` times per survivor and the median-fastest wins,
    first-listed winning ties.  Returns the chosen candidate."""
    cands = list(candidates)
    if not cands:
        raise ValueError("tune() needs at least one candidate")
    if price is not None and len(cands) > top_k:
        priced = sorted(range(len(cands)), key=lambda i: (price(cands[i]), i))
        cands = [cands[i] for i in priced[:top_k]]
    best, best_t = None, None
    for c in cands:
        t = statistics.median(measure(c) for _ in range(max(1, reps)))
        if best_t is None or t < best_t:
            best, best_t = c, t
    if table is not None:
        table.put(op, rows, dtype, param, best)
    return best
