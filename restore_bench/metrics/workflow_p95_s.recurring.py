"""95th percentile of every window workflow's latency, from its submit
to its outputs' row counts on the host (host clock).  A per-layer
number: its run-to-run spread in the recurring cell is too wide for a
bound."""
from ._common import p95


def read(run):
    return p95([e["done"] - e["submit"] for e in run.events])
