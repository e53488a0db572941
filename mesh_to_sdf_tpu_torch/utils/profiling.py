"""Spans on the profiler's timeline, phase timing and throughput records.

Parity with the reference's tracing story (SURVEY.md §5): the grid generator
logs per-phase step counts and wall-times (`grid.rs:278-279,303-307,341-347`),
the client surfaces the last run's timing in the UI (`sdf.rs:49-60`,
`ui.rs:237-246`). Here:

- :func:`span` names a piece of the port's work on the timeline of
  ``torch.profiler``: a ``record_function`` event, beside the kernels,
  copies and fills the profiler records on the card. Spans nest on the
  calling thread, so every span of one call sits under that call's entry
  span (``grid.entry``, ``query.entry``). Tracing is on exactly while a
  profiler runs; otherwise a span is a shared no-op that costs one check.
  :func:`spanned` is its decorator form.
- :func:`sync_span` marks a place that makes the host wait on the card (a
  copy between host and card memory, a read of a card tensor on the host),
  one wait per span, named ``sync.<path>.<site>``.
- ``PhaseTimer`` (used by the CLI), a ``LastRunInfo`` record.

To trace a call, run it under ``torch.profiler.profile(activities=[CPU,
CUDA])`` and export its Chrome trace.
"""
from __future__ import annotations

import contextlib
import functools
import logging
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch

logger = logging.getLogger("mesh_to_sdf_tpu")

_profiler_enabled = torch.autograd._profiler_enabled

#: What every span is while no profiler runs.
_OFF = contextlib.nullcontext()


def span(name: str):
    """The span ``name`` (dotted, ``<path>.<layer>``) as a context manager:
    ``torch.profiler.record_function(name)`` while a torch profiler runs
    (``torch.autograd._profiler_enabled()``), else one shared no-op, so an
    untraced call allocates nothing for it."""
    if _profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF


def spanned(name: str):
    """Decorator: :func:`span` ``name`` around every call of the function
    (opened or not as each call finds the profiler)."""
    def decorate(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return decorate


def _on_card(place) -> bool:
    if isinstance(place, torch.Tensor):
        return place.is_cuda
    if isinstance(place, (str, torch.device)):
        return torch.device(place).type == "cuda"
    return False  # None, a numpy array: the host


def sync_span(name: str, *places):
    """:func:`span` ``name`` around one statement that makes the host wait
    on the card; one wait per span, so a statement that waits twice is
    split. ``places`` (tensors or devices) say where the statement's data
    is: one place, which the host reads or fills (``int(t)``, ``nonzero``,
    a mask index, ``x.to(device)`` of a host tensor), or a copy's source
    and destination. It waits, and the span opens, when exactly one of
    them, with the host beside a single place, is on CUDA."""
    if not _profiler_enabled():
        return _OFF
    on_card = {_on_card(p) for p in places}
    if len(places) == 1:
        on_card.add(False)  # the host
    return span(name) if on_card == {True, False} else _OFF


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
