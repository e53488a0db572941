"""One run of one cell: set-up, the window, the checks, the metrics.

Set-up (timed as ``setup_s``, from process start to the first timed call)
builds or loads ``native/libm2s.so`` and the port's kernel library, makes
the cell's inputs from the seed and makes one cold and one warm call at
the cell's own shapes. The window then runs closed-loop calls, each ending
in ``torch.cuda.synchronize()``. After it the run checks the modules the
process loaded and the route every call took, frees the program's state,
and holds a sample of the timed calls' answers (a reservoir drawn from the
seed) against the plain reference.
"""
from __future__ import annotations

import contextlib
import gc
import importlib
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from benchmark.harness import guards, manifest, trace, traffic, window
from benchmark.reference import exact

#: The control's precision: the nearest below the one a configuration
#: states.
CONTROL_DTYPE = {"float64": torch.float32, "float32": torch.bfloat16}


@dataclass
class Context:
    """What a metric's reader reads (``read(ctx)`` in ``metrics/``)."""

    cell: manifest.Cell
    window: window.Window
    setup_s: float
    peak_mem_bytes: int
    n_triangles: int
    summary: Optional[trace.Summary] = None

    @property
    def n_calls(self) -> int:
        return len(self.window.calls)

    @property
    def notes(self) -> list:
        return [c.note for c in self.window.calls]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _metric_readers(cell: manifest.Cell, trace_on: bool) -> dict:
    return {m["name"]: manifest.load_metric(m["name"], cell.bench_dir)
            for m in cell.metrics(trace_on)}


def _launch_range(launches: list) -> dict:
    """[least, most] kernel launches per call, for each kernel launched."""
    out = {}
    for d in launches:
        for k, (n, _) in d.items():
            lo, hi = out.get(k, (n, n))
            out[k] = (min(lo, n), max(hi, n))
    return {k: list(v) for k, v in out.items() if v[1] > 0}


def _tally(notes: list) -> dict:
    """How many calls noted each value of each key with few values."""
    out = {}
    for n in notes:
        for k, v in n.items():
            if isinstance(v, str):
                out.setdefault(k, {})
                out[k][v] = out[k].get(v, 0) + 1
    return out


def run_cell(cell: manifest.Cell, seed: int, seconds: float, trace_on: bool,
             *, t0: float, root: Path = manifest.ROOT, device="cuda",
             on_card: bool = True, control: bool = False) -> dict:
    """Run ``cell`` once and return its result line as a dict.

    ``on_card=False`` runs on ``device`` (the CPU in tests) without the
    card's builds and route checks; ``control=True`` puts the reference,
    computed one precision below the configuration's, in the program's
    place for the comparison."""
    device = torch.device(device)
    # Interpreter and imports, before this function.
    setup = {"start_s": time.perf_counter() - t0}
    readers = _metric_readers(cell, trace_on)
    if on_card:
        t = time.perf_counter()
        torch.empty(1, device=device)
        _sync(device)
        setup["context_s"] = time.perf_counter() - t
    guards.import_port(root)
    if on_card:
        t = time.perf_counter()
        guards.build_native(root)
        from mesh_to_sdf_tpu_torch.ops.kernels import _build

        _build.lib()
        setup["build_s"] = time.perf_counter() - t
    t = time.perf_counter()
    feed = traffic.make_feed(cell.traffic, cell.config["mesh"], seed, device,
                             seconds)
    entry_mod = importlib.import_module(
        f"benchmark.entries.{cell.config['entry']}")
    entry = entry_mod.Entry(cell.config, feed, device, seed)
    _sync(device)
    setup["inputs_s"] = time.perf_counter() - t
    for j, key in ((0, "cold_s"), (1, "warm_s")):
        t = time.perf_counter()
        entry.call(-1 - j)
        _sync(device)
        setup[key] = time.perf_counter() - t

    counters = guards.launch_counters()
    k_keep = int(cell.config["check"]["calls"])
    rng = np.random.default_rng(traffic.derive(seed, "check calls"))
    kept, launches = [], []
    note = getattr(entry, "note", None)
    mark = (lambda: torch.profiler.record_function(trace.CALL)) if trace_on \
        else contextlib.nullcontext

    tracer = None
    if trace_on:
        specs = [tuple(s) for r in readers.values()
                 for s in getattr(r, "SPANS", ())]
        tracer = trace.Tracer(
            specs, cell.bench_dir / "out" / "traces" / f"{cell.name}.json",
            cuda=device.type == "cuda")

    def timed(i):
        before = guards.snapshot(counters)
        with mark():
            out = entry.call(i)
            _sync(device)
        delta = guards.launch_delta(before, guards.snapshot(counters))
        launches.append(delta)
        slot = i if i < k_keep else int(rng.integers(0, i + 1))
        if slot < k_keep:
            item = (i, entry.sample(out))
            if slot < len(kept):
                kept[slot] = item
            else:
                kept.append(item)
        if tracer is not None:
            tracer.after_call(time.perf_counter())
        return entry.work_per_call, (note(delta) if note else {})

    setup_peak = 0
    if device.type == "cuda":
        setup_peak = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    if tracer is not None:
        tracer.start()
    setup_s = time.perf_counter() - t0
    win = window.run(timed, seconds,
                     fatal=(traffic.OutOfInputs, guards.GuardError))
    _sync(device)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    summary = tracer.finish() if tracer is not None else None
    guards.check_imports()
    if on_card:
        guards.check_route(launches, cell.config["route"])

    # The program's state goes before the reference runs.
    ref_inputs = [(i, vals.cpu(), entry.reference_inputs(i))
                  for i, vals in sorted(kept, key=lambda kv: kv[0])]
    n_tris = len(feed.faces)
    entry.release()
    feed.mesh_vertices = feed.pool = None
    del kept
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    t = time.perf_counter()
    worst, worst_at = {}, {}
    ctl = CONTROL_DTYPE[cell.config.get("precision", "float32")]
    for _, got, (points, tris) in ref_inputs:
        ref_s, ref_u = exact.signed_distance(
            torch.from_numpy(points), torch.from_numpy(tris), device=device)
        if control:
            got = exact.signed_distance(
                torch.from_numpy(points), torch.from_numpy(tris),
                dtype=ctl, device=device)[0].to(torch.float32)
        numbers, at = entry.compare(got, ref_s, ref_u)
        for k, v in numbers.items():
            if k not in worst or v > worst[k]:
                worst[k] = v
                if k in at:
                    worst_at[k] = at[k]
    check_s = time.perf_counter() - t
    limits = entry.limits()
    correct = (win.failed == 0 and set(worst) == set(limits)
               and all(worst[k] <= limits[k] for k in limits))

    ctx = Context(cell=cell, window=win, setup_s=setup_s,
                  peak_mem_bytes=int(peak), n_triangles=n_tris,
                  summary=summary)
    metrics = {}
    for m in cell.metrics(trace_on):
        v = readers[m["name"]].read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else device.type),
           "count": cell.chips if device.type == "cuda" else 1,
           "memory_peak_bytes": int(max(setup_peak, peak))}
    result = {"correct": bool(correct), "attempted": len(win.calls),
              "failed": win.failed, "metrics": metrics, "device": dev}
    if summary is not None:
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = summary.window_s
        result["breakdown"] = summary.breakdown()
    result["run"] = {
        "calls": len(win.calls), "window_s": win.seconds,
        "part_rates": window.part_rates(win),
        "setup": setup, "check_s": check_s,
        "checked_calls": [i for i, _, _ in ref_inputs],
        "errors": sorted({c.error for c in win.calls if c.error})[:3],
        "launches_per_call": _launch_range(launches),
        "notes": _tally(ctx.notes),
        "control": control,
        "worst_at_ref_distance": worst_at}
    result["check"] = {k: {"value": worst.get(k), "limit": limits[k]}
                       for k in limits}
    return result
