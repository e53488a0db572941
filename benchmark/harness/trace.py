"""The traced run: spans around the port's layer entry points, the
profiler over the window, and the reduction of its trace.

Spans come from the benchmark's own files: each per-layer metric's reader
lists the (module, attribute, span) it needs in ``SPANS``, and
:func:`wrap` replaces each attribute by a wrapper that opens a
``torch.profiler.record_function`` span around it. The reduction reads the
profiler's Chrome trace: a kernel's (or copy's) device time goes to every
span that was open, on the launching thread, when the runtime call that
launched it ran (matched by the trace's correlation ids).
"""
from __future__ import annotations

import functools
import importlib
import json
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

#: The span around the whole window and around each timed call.
WINDOW = "bench.window"
CALL = "bench.call"
#: Trace categories of device work and of the host calls that launch it.
DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
LAUNCH_CATS = {"cuda_runtime", "cuda_driver"}
HOST_SPAN_CAT = "user_annotation"
HOST_OP_CAT = "cpu_op"
#: Entries kept in each list of the breakdown.
TOP = 10
#: Characters kept of a device op's name (C++ kernel names run long).
NAME_CHARS = 160
#: Seconds of the window the profiler traces (whole calls): enough calls
#: for per-call averages, and a trace of some tens of MB.
SECONDS = 4.0


def wrap(specs) -> callable:
    """Open a span named ``span`` around every call of ``module.attr`` for
    each (module, attr, span) in ``specs``; returns the function that puts
    the originals back."""
    import torch

    undo = []
    seen = set()
    for module, attr, span in specs:
        if (module, attr) in seen:
            continue
        seen.add((module, attr))
        mod = importlib.import_module(module)
        fn = getattr(mod, attr)

        def make(fn=fn, span=span):
            @functools.wraps(fn)
            def spanned(*args, **kwargs):
                with torch.profiler.record_function(span):
                    return fn(*args, **kwargs)
            return spanned

        setattr(mod, attr, make())
        undo.append((mod, attr, fn))

    def restore():
        for mod, attr, fn in reversed(undo):
            setattr(mod, attr, fn)

    return restore


@dataclass
class Summary:
    """What the per-layer readers read from one traced window."""

    window_s: float
    busy_s: float
    #: span name -> (occurrences, host seconds, device seconds)
    spans: dict = field(default_factory=dict)
    #: device op name -> seconds, in the window
    device_ops: dict = field(default_factory=dict)
    #: what the host was doing -> seconds the device sat idle
    idle_gaps: dict = field(default_factory=dict)

    @property
    def calls(self) -> int:
        """Timed calls in the traced window."""
        return self.span_count(CALL)

    def span_count(self, name: str) -> int:
        return self.spans.get(name, (0, 0.0, 0.0))[0]

    def span_host_s(self, name: str) -> float:
        return self.spans.get(name, (0, 0.0, 0.0))[1]

    def span_device_s(self, name: str) -> float:
        return self.spans.get(name, (0, 0.0, 0.0))[2]

    def breakdown(self) -> dict:
        def top(d):
            return [[k, v] for k, v in sorted(d.items(),
                                              key=lambda kv: -kv[1])[:TOP]]
        return {"device_ops": top(self.device_ops),
                "idle_gaps": top(self.idle_gaps)}


def _union(intervals):
    """Sorted, merged (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def _innermost(spans_by_name, t):
    """The name of the latest-opened span that holds time ``t``, or
    None: ``spans_by_name`` maps name -> (starts, ends) sorted arrays."""
    best, best_start = None, -np.inf
    for name, (starts, ends) in spans_by_name.items():
        j = int(np.searchsorted(starts, t, side="right")) - 1
        if j >= 0 and ends[j] >= t and starts[j] > best_start:
            best, best_start = name, starts[j]
    return best


def _innermost_op(ops, starts, t, reach: int = 512):
    """The name of the latest-started host op of ``ops`` (sorted (start,
    end, name)) that holds time ``t``, looking back at most ``reach`` ops;
    or None."""
    j = int(np.searchsorted(starts, t, side="right")) - 1
    for k in range(j, max(j - reach, -1), -1):
        if ops[k][1] >= t:
            return ops[k][2]
    return None


def reduce(trace) -> Summary:
    """Reduce a profiler trace (a path to its Chrome JSON, or the loaded
    object) to a :class:`Summary` of its ``bench.window`` span. Times in
    the trace are microseconds."""
    if not isinstance(trace, dict):
        with open(trace) as f:
            trace = json.load(f)
    events = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
    win = [e for e in events if e.get("cat") == HOST_SPAN_CAT
           and e.get("name") == WINDOW]
    if not win:
        raise ValueError(f"trace has no {WINDOW!r} span")
    w = win[0]
    w0, w1 = float(w["ts"]), float(w["ts"]) + float(w["dur"])
    thread = (w.get("pid"), w.get("tid"))

    def on_thread(e):
        return (e.get("pid"), e.get("tid")) == thread

    host_spans = {}
    for e in events:
        if e.get("cat") == HOST_SPAN_CAT and on_thread(e) and \
                e.get("name") != WINDOW:
            host_spans.setdefault(e["name"], []).append(
                (float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    spans_by_name = {}
    for name, occ in host_spans.items():
        occ.sort()
        spans_by_name[name] = (np.array([s for s, _ in occ]),
                               np.array([t for _, t in occ]))

    launch_ts = {}
    for e in events:
        if e.get("cat") in LAUNCH_CATS and on_thread(e):
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launch_ts[corr] = float(e["ts"])

    device = [e for e in events if e.get("cat") in DEVICE_CATS]
    busy, ops = [], {}
    dev_corr_ts, dev_dur = [], []
    for e in device:
        s, d = float(e["ts"]), float(e["dur"])
        cs, ce = max(s, w0), min(s + d, w1)
        if ce > cs:
            busy.append((cs, ce))
            name = e["name"][:NAME_CHARS]
            ops[name] = ops.get(name, 0.0) + (ce - cs) * 1e-6
        corr = e.get("args", {}).get("correlation")
        if corr in launch_ts:
            dev_corr_ts.append(launch_ts[corr])
            dev_dur.append(d)
    merged = _union(busy)
    busy_s = sum(e - s for s, e in merged) * 1e-6

    lts = np.array(dev_corr_ts)
    ldur = np.array(dev_dur)
    spans = {}
    for name, (starts, ends) in spans_by_name.items():
        dev_s = 0.0
        if len(lts):
            j = np.searchsorted(starts, lts, side="right") - 1
            ok = (j >= 0) & (ends[np.clip(j, 0, None)] >= lts)
            dev_s = float(ldur[ok].sum()) * 1e-6
        spans[name] = (len(starts), float((ends - starts).sum()) * 1e-6,
                       dev_s)

    host_ops = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                       e["name"]) for e in events
                      if e.get("cat") == HOST_OP_CAT and on_thread(e))
    op_starts = np.array([o[0] for o in host_ops])
    gaps = {}
    t = w0
    for s, e in merged + [[w1, w1]]:
        if s > t:
            mid = 0.5 * (t + s)
            name = _innermost(spans_by_name, mid) or "no span"
            op = _innermost_op(host_ops, op_starts, mid)
            if op is not None:
                name += " / " + op
            gaps[name] = gaps.get(name, 0.0) + (s - t) * 1e-6
        t = max(t, e)
    return Summary(window_s=(w1 - w0) * 1e-6, busy_s=busy_s, spans=spans,
                   device_ops=ops, idle_gaps=gaps)


class Tracer:
    """The profiler over the first :data:`SECONDS` of the window (whole
    calls), with the spans of ``specs`` open around their layers; the rest
    of the window runs with the profiler stopped. A traced run reports
    per-layer metrics only, so the stop costs no measured time."""

    def __init__(self, specs, out_path: Path, cuda: bool):
        import torch

        self.seconds = SECONDS
        self.path = Path(out_path)
        self.restore = wrap(specs)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(
            activities=acts, record_shapes=False, with_stack=False,
            profile_memory=False)
        self.span = torch.profiler.record_function(WINDOW)
        self.active = False
        self.t0 = 0.0

    def start(self, clock=time.perf_counter) -> None:
        """Start the profiler; the traced seconds count from when it is
        running (starting it takes seconds of its own)."""
        self.prof.start()
        self.span.__enter__()
        self.t0 = clock()
        self.active = True

    def after_call(self, now: float) -> None:
        if self.active and now - self.t0 >= self.seconds:
            self.stop()

    def stop(self) -> None:
        if self.active:
            self.span.__exit__(None, None, None)
            self.prof.stop()
            self.active = False

    def finish(self) -> Summary:
        """Stop, put the layers back, write the trace, and reduce it."""
        self.stop()
        self.restore()
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.prof.export_chrome_trace(str(self.path))
        return reduce(self.path)
