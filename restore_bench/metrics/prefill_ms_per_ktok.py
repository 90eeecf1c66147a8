"""Span time around Model.prefill, synchronised, per 1000 prefilled
tokens (ms)."""


def read(run):
    ms = sum((t1 - t0) / 1e6 for n, t0, t1 in run.spans
             if n == "model.prefill")
    n = run.counters.get("prefill_tokens", 0)
    return 1e3 * ms / n if n else None
