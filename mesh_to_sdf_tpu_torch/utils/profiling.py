"""Phase timing + throughput observability.

Parity with the reference's tracing story (SURVEY.md §5): the grid generator
logs per-phase step counts and wall-times (`grid.rs:278-279,303-307,341-347`),
the client surfaces the last run's timing in the UI (`sdf.rs:49-60`,
`ui.rs:237-246`). Here: a ``PhaseTimer`` used by the generators/CLI, a
``LastRunInfo`` record, and helpers for cells/s-per-chip metrics. For deep
traces use ``jax.profiler.trace`` around any call (XLA-level timeline).
"""
from __future__ import annotations

import contextlib
import logging
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

logger = logging.getLogger("mesh_to_sdf_tpu")


@dataclass
class LastRunInfo:
    """The client's `LastRunInfo` (`sdf_program.rs:716-719`): size + seconds."""

    cells: int = 0
    triangles: int = 0
    seconds: float = 0.0

    @property
    def cells_per_s(self) -> float:
        return self.cells / self.seconds if self.seconds > 0 else 0.0


class PhaseTimer:
    """Accumulates named phase wall-times (the reference's per-phase logs)."""

    def __init__(self):
        self.times: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.times[name] = self.times.get(name, 0.0) + dt
            logger.info("phase %s: %.3fs", name, dt)

    def summary(self) -> str:
        total = sum(self.times.values())
        parts = [f"{k}={v:.3f}s" for k, v in self.times.items()]
        return f"{' '.join(parts)} total={total:.3f}s"
