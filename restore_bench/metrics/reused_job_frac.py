"""Share of a window's job outputs served by reuse: RunReport n_reused
over n_reused + n_executed, summed over the window's workflows (%)."""


def read(run):
    r = sum(e["n_reused"] for e in run.events)
    x = sum(e["n_executed"] for e in run.events)
    return 100.0 * r / (r + x) if r + x else None
