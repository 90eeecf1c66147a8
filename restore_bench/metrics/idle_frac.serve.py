"""Share of the traced window with no device activity (%)."""
from ._common import idle_pct


def read(run):
    return idle_pct(run)
