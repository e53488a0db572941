"""``BENCHMARK.json`` and the files it names.

A cell (an entry of ``workloads``) names a configuration and a traffic mix;
each is found by name: the configuration's file is the one its entry in
``configs`` gives, the mix is ``traffic/<traffic>.json`` and each metric is
``metrics/<name>.py``, all under the benchmark's directory. Adding a cell,
a mix or a metric adds files and entries and edits none.
"""
from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

#: The benchmark's own directory (``paths`` of ``BENCHMARK.json``).
BENCH_DIR = Path(__file__).resolve().parents[1]
#: The root of the checkout: ``BENCHMARK.json`` and the port.
ROOT = BENCH_DIR.parent

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH_RE = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}


@dataclass
class Cell:
    """One cell, with everything found for it by name."""

    name: str
    workload: dict
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list
    bench_dir: Path

    @property
    def chips(self) -> int:
        return int(self.workload["chips"])

    def metrics(self, trace: bool) -> list:
        """The metric entries a run reports: per-layer with a trace, else
        end-to-end."""
        return self.per_layer if trace else self.end_to_end


def load(root: Path = ROOT) -> dict:
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(manifest: dict, name: str, bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell ``name`` and its configuration, mix and metrics. Raises
    ``KeyError`` for a name the manifest does not hold."""
    by_name = {w["name"]: w for w in manifest["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(by_name)})")
    w = by_name[name]
    cfg_entry = {c["name"]: c for c in manifest["configs"]}[w["config"]]
    root = Path(bench_dir).parent
    with open(root / cfg_entry["file"]) as f:
        config = json.load(f)
    with open(Path(bench_dir) / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    return Cell(
        name=name, workload=w, config=config, traffic=traffic,
        end_to_end=[m for m in manifest["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in manifest["per_layer"] if _applies(m, name)],
        bench_dir=Path(bench_dir))


def load_metric(name: str, bench_dir: Path = BENCH_DIR):
    """The reader module ``metrics/<name>.py`` (loaded by path: metric
    names hold dots)."""
    path = Path(bench_dir) / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + re.sub(r"\W", "_", name), path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _line(s, limit: int = 200) -> bool:
    return (isinstance(s, str) and 1 <= len(s) <= limit and "\n" not in s
            and "\t" not in s)


def problems(manifest: dict, root: Optional[Path] = None) -> list:
    """What in ``manifest`` breaks the benchmark's rules on names, units,
    keys and references (an empty list when nothing does). With ``root``,
    also that every named file exists under it."""
    out = []
    if set(manifest) != TOP_KEYS:
        out.append(f"top-level keys {sorted(manifest)}")
    cmd = manifest.get("command", [])
    if not (1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)):
        out.append("command")
    paths = manifest.get("paths", [])
    if not 1 <= len(paths) <= 16:
        out.append("paths: 1 to 16 directories")
    for p in paths:
        if (not PATH_RE.match(p) or p.startswith("/") or ".." in
                p.split("/")):
            out.append(f"path {p!r}")
    rs = manifest.get("run_seconds")
    if not (isinstance(rs, int) and 1 <= rs <= 51):
        out.append("run_seconds")

    def in_paths(f):
        return any(f == p or f.startswith(p.rstrip("/") + "/")
                   for p in paths)

    names = set()

    def name_ok(kind, n):
        if not (isinstance(n, str) and NAME_RE.match(n)):
            out.append(f"{kind} name {n!r}")

    cfg_names = set()
    for c in manifest.get("configs", []):
        if set(c) != {"name", "source", "file", "reduced", "why"}:
            out.append(f"config keys {sorted(c)}")
        name_ok("config", c.get("name"))
        cfg_names.add(c.get("name"))
        if not (_line(c.get("source")) and _line(c.get("why"))):
            out.append(f"config {c.get('name')}: source or why")
        if not in_paths(c.get("file", "")):
            out.append(f"config {c.get('name')}: file outside paths")
        red = c.get("reduced", [])
        if len(red) > 16:
            out.append(f"config {c.get('name')}: reduced")
        for k in red:
            name_ok("reduced key", k)
        if root is not None and not (Path(root) / c.get("file", "")).is_file():
            out.append(f"config {c.get('name')}: no file {c.get('file')}")
    if len(cfg_names) != len(manifest.get("configs", [])):
        out.append("duplicate config names")
    cells = set()
    used = set()
    pairs = set()
    for w in manifest.get("workloads", []):
        if set(w) != {"name", "config", "traffic", "chips", "why"}:
            out.append(f"workload keys {sorted(w)}")
        for k in ("name", "config", "traffic"):
            name_ok(f"workload {k}", w.get(k))
        if w.get("config") not in cfg_names:
            out.append(f"workload {w.get('name')}: unknown config")
        if w.get("chips") not in (1, 4):
            out.append(f"workload {w.get('name')}: chips")
        if not _line(w.get("why")):
            out.append(f"workload {w.get('name')}: why")
        pair = (w.get("config"), w.get("traffic"))
        if pair in pairs:
            out.append(f"workload {w.get('name')}: repeated pair")
        pairs.add(pair)
        cells.add(w.get("name"))
        used.add(w.get("config"))
        if root is not None and not (
                Path(root) / paths[0] / "traffic"
                / f"{w.get('traffic')}.json").is_file():
            out.append(f"workload {w.get('name')}: no traffic file")
    if len(cells) != len(manifest.get("workloads", [])):
        out.append("duplicate workload names")
    if cfg_names - used:
        out.append(f"configs used by no cell: {sorted(cfg_names - used)}")
    e2e_names = set()
    for kind in ("end_to_end", "per_layer"):
        for m in manifest.get(kind, []):
            keys = {"name", "unit", "better", "source"}
            keys |= ({"bound"} if kind == "end_to_end"
                     else {"layer", "moves"})
            if not keys <= set(m) <= keys | {"workloads"}:
                out.append(f"{kind} {m.get('name')}: keys {sorted(m)}")
            name_ok("metric", m.get("name"))
            if m.get("name") in names:
                out.append(f"duplicate metric {m.get('name')}")
            names.add(m.get("name"))
            if not (isinstance(m.get("unit"), str)
                    and UNIT_RE.match(m["unit"])):
                out.append(f"metric {m.get('name')}: unit {m.get('unit')!r}")
            if m.get("better") not in ("lower", "higher"):
                out.append(f"metric {m.get('name')}: better")
            if m.get("source") not in SOURCES or (
                    kind == "end_to_end" and m.get("source")
                    not in ("host_clock", "device_trace")):
                out.append(f"metric {m.get('name')}: source")
            for c in m.get("workloads", []):
                if c not in cells:
                    out.append(f"metric {m.get('name')}: unknown cell {c}")
            if kind == "end_to_end":
                e2e_names.add(m.get("name"))
                b = m.get("bound")
                if not (isinstance(b, (int, float)) and 0.01 <= b <= 0.25):
                    out.append(f"metric {m.get('name')}: bound {b}")
            else:
                if not _line(m.get("layer")):
                    out.append(f"metric {m.get('name')}: layer")
            if root is not None and not (
                    Path(root) / paths[0] / "metrics"
                    / f"{m.get('name')}.py").is_file():
                out.append(f"metric {m.get('name')}: no reader file")
    e2e_by_name = {m.get("name"): m for m in manifest.get("end_to_end", [])}
    for m in manifest.get("per_layer", []):
        moved = e2e_by_name.get(m.get("moves"))
        if moved is None:
            out.append(f"metric {m.get('name')}: moves {m.get('moves')}")
            continue
        for c in cells:
            if _applies(m, c) and not _applies(moved, c):
                out.append(f"metric {m.get('name')}: cell {c} does not "
                           f"report {m.get('moves')}")
    if "setup_s" not in e2e_names:
        out.append("no setup_s")
    for c in cells:
        e2e = [m for m in manifest.get("end_to_end", []) if _applies(m, c)]
        if not any(m["name"] == "setup_s" for m in e2e) or len(e2e) < 2:
            out.append(f"cell {c}: end-to-end metrics")
        if not any(_applies(m, c) for m in manifest.get("per_layer", [])):
            out.append(f"cell {c}: no per-layer metric")
    return out
