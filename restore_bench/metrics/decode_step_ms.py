"""Mean span around Model.decode_step, synchronised (ms)."""
from ._common import span_mean_ms


def read(run):
    return span_mean_ms(run, "model.decode_step")
