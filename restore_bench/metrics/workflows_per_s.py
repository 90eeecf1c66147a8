"""Workflows completed inside the window, over its length (host clock)."""


def read(run):
    return sum(1 for e in run.events if e["done"] <= run.t_end) / run.window_s
