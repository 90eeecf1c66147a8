"""Tokens the session emitted inside the window, over its length: a token
is emitted when the decode step after it is called (host clock)."""


def read(run):
    n = sum(1 for t in run.marks if t <= run.t_end)
    return n / run.window_s if n else None
