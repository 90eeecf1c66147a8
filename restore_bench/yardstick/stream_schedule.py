"""The stream's template popularity, frozen from
``repro_torch/workloads/stream.py::_event_schedule``: a Zipf(s) rank
distribution over the templates, mapped through a per-tenant
permutation drawn from ``seed + 101 + tenant``, so tenants share hot
templates and keep favourites of their own.  ``tenant_streams`` is its
closed-loop form: the same ranks and permutations, one sequence a
tenant."""
from __future__ import annotations

import numpy as np


def zipf_p(n: int, s: float) -> np.ndarray:
    p = 1.0 / np.arange(1, n + 1) ** s
    return p / p.sum()


def event_schedule(seed: int, n_templates: int, n_tenants: int, s: float,
                   n_events: int):
    """``stream.py::_event_schedule``'s (tenant, template) sequence: a
    tenant drawn per event, a Zipf rank mapped through that tenant's
    permutation."""
    rng = np.random.default_rng(seed)
    p = zipf_p(n_templates, s)
    perms = [np.random.default_rng(seed + 101 + t).permutation(n_templates)
             for t in range(n_tenants)]
    out = []
    for _ in range(n_events):
        tenant = int(rng.integers(n_tenants))
        rank = int(rng.choice(n_templates, p=p))
        out.append((tenant, int(perms[tenant][rank])))
    return out


def tenant_streams(seed: int, n_templates: int, n_tenants: int, s: float,
                   n_per_tenant: int):
    """Each tenant's template sequence for a closed loop: Zipf(s) ranks
    drawn from ``seed + 1000 + tenant``, mapped through the tenant's
    permutation as in ``event_schedule``."""
    p = zipf_p(n_templates, s)
    out = []
    for t in range(n_tenants):
        perm = np.random.default_rng(seed + 101 + t).permutation(n_templates)
        ranks = np.random.default_rng(seed + 1000 + t).choice(
            n_templates, size=n_per_tenant, p=p)
        out.append([int(x) for x in perm[ranks]])
    return out
