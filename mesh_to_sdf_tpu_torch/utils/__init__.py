"""Utilities: profiling/observability and procedural meshes."""
from .profiling import LastRunInfo, PhaseTimer, logger
from .meshgen import box, icosphere, torus

__all__ = ["LastRunInfo", "PhaseTimer", "logger", "box", "icosphere", "torus"]
