"""Share of the window's prompt tokens served from a stored prefix:
reused over reused + prefilled, from each request's ServeStats (%)."""


def read(run):
    r = sum(e["reused"] for e in run.events)
    p = sum(e["prefilled"] for e in run.events)
    return 100.0 * r / (r + p) if r + p else None
