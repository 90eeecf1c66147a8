"""Mean over the window's workflows of latency minus the wall of their
executed jobs (JobStats.wall_s): the driver, repository, service queue
and client hand-off (ms)."""
import numpy as np


def read(run):
    v = [e["done"] - e["submit"] - sum(e["job_walls"]) for e in run.events]
    return 1e3 * float(np.mean(v)) if v else None
