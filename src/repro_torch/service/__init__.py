"""Concurrent multi-tenant ReStore service (DESIGN.md §13).

``ReStoreService`` runs whole workflows on a worker pool over one shared
catalog/store/repository; ``RepositoryJournal`` makes repository state
crash-durable; ``FaultInjector`` drives the seeded fault-injection
suites against the store's IO choke points.
"""
from .faults import FaultInjector, FaultSchedule           # noqa: F401
from .journal import RepositoryJournal, replay_journal     # noqa: F401
from .service import (ReStoreService, ServiceOverloaded,   # noqa: F401
                      ServiceTimeout, Ticket)
