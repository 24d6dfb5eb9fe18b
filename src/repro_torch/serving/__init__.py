"""Serving tier: the concurrent front door over MicroNN (frontdoor.py)."""
from .frontdoor import FrontDoor, FrontDoorConfig, empty_stats

__all__ = ["FrontDoor", "FrontDoorConfig", "empty_stats"]
