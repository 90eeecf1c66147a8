"""95th percentile of every window request's time to first token, from
the request's start (host clock).  A per-layer number: its run-to-run
spread in the docqa cell is too wide for a bound."""
from ._common import p95


def read(run):
    return p95([e["first"] - e["start"] for e in run.events])
