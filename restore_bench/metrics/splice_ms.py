"""Mean span around KVRepository.splice, synchronised (ms)."""
from ._common import span_mean_ms


def read(run):
    return span_mean_ms(run, "kv.splice")
