"""Fleet mode (port of repro.fleet): many per-tenant MicroNN engines
behind ONE memory budget and one maintenance daemon.

  * `pool`    -- FramePool: the budget-bounded frame pool shared by every
                 tenant's pager view (global CLOCK eviction, per-tenant pin
                 accounting, the eviction matrix).
  * `manager` -- Fleet: open/get/close tenants with lazy recover, an LRU of
                 live engine handles that spills idle tenants, the SQLite
                 manifest and SLO health; FleetScheduler: one
                 deficit-round-robin maintenance daemon for the whole
                 fleet; TenantSLO.

`manager` imports the engine, so it loads lazily (PEP 562): the pager
imports `fleet.pool` without a circular import through `storage.engine`.
"""
from .pool import FramePool, compute_frame_bytes

_LAZY = ("Fleet", "FleetScheduler", "TenantSLO")


def __getattr__(name):
    if name in _LAZY:
        from . import manager as _manager
        return getattr(_manager, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_LAZY))


__all__ = ["FramePool", "compute_frame_bytes", "Fleet", "FleetScheduler",
           "TenantSLO", "pool"]
