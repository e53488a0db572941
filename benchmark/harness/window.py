"""The measured window: one caller, closed loop.

Calls run back to back until the first call that ends after the window's
length. A rate is all the work of every call over all the time of the
window (from its start to the end of its last call); a tail is taken over
every call in it.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Callable, Optional


@dataclass
class Call:
    """One timed call: host-clock start and end (s), the work it did (cells
    or queries), and what the caller noted about it."""

    t0: float
    t1: float
    work: float
    note: dict = field(default_factory=dict)
    error: Optional[str] = None

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


@dataclass
class Window:
    start: float
    end: float
    calls: list

    @property
    def seconds(self) -> float:
        return self.end - self.start

    @property
    def failed(self) -> int:
        return sum(c.error is not None for c in self.calls)


def run(call: Callable[[int], tuple], seconds: float,
        clock: Callable[[], float] = time.perf_counter,
        fatal: tuple = ()) -> Window:
    """Run ``call(i)`` for i = 0, 1, ... until a call ends ``seconds`` or
    more after the window opened. ``call`` returns (work, note) once its
    result is complete (its device work synchronised). A call that raises
    is recorded with its error and no work, and the loop goes on: the run
    reports it as failed. An exception of a type in ``fatal`` ends the
    run instead."""
    calls = []
    start = clock()
    deadline = start + seconds
    i = 0
    while True:
        t0 = clock()
        try:
            work, note = call(i)
            err = None
        except fatal:
            raise
        except Exception as e:  # noqa: BLE001 — counted as a failed call
            work, note, err = 0.0, {}, f"{type(e).__name__}: {e}"
        t1 = clock()
        calls.append(Call(t0, t1, float(work), note, err))
        i += 1
        if t1 >= deadline:
            return Window(start, t1, calls)


def rate(win: Window) -> float:
    """All the work of the window over all its time."""
    return sum(c.work for c in win.calls) / win.seconds


def percentile(values, q: float) -> float:
    """The nearest-rank ``q``-th percentile (0 < q <= 100): the smallest
    value with at least q % of the values at or below it."""
    if not values:
        raise ValueError("no values")
    xs = sorted(values)
    k = max(math.ceil(q / 100.0 * len(xs)), 1)
    return xs[k - 1]


def call_p95_ms(win: Window) -> float:
    """The 95th percentile of every call's time in the window, ms."""
    return 1e3 * percentile([c.seconds for c in win.calls], 95.0)


def part_rates(win: Window, parts: int = 5) -> list:
    """The rate in each of ``parts`` equal slices of the window, a call's
    work counted in the slice its end falls in: whether a run's rate drifts
    within its window, or only from run to run."""
    width = win.seconds / parts
    work = [0.0] * parts
    for c in win.calls:
        k = min(int((c.t1 - win.start) / width), parts - 1)
        work[k] += c.work
    return [w / width for w in work]
