"""Serving tier: the concurrent front door over MicroNN (frontdoor.py)
and the continuous-batching LM decode engine (engine.py).

`ServeEngine`/`Request` pull in the model stack, so they load lazily
(PEP 562): the storage layer imports the light FrontDoor module without
the transformer code.
"""
from .frontdoor import FrontDoor, FrontDoorConfig, empty_stats

__all__ = ["FrontDoor", "FrontDoorConfig", "empty_stats", "Request",
           "ServeEngine"]

_LAZY = ("Request", "ServeEngine")


def __getattr__(name):
    if name in _LAZY:
        from . import engine as _engine
        return getattr(_engine, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_LAZY))
