#!/usr/bin/env python3
"""Run one cell several times, one process after another, and report the
spread of each metric.

    python3 benchmark/tools/spread.py --workload <cell> --seeds 1,2,3 \
        [--sets 2] [--seconds 20] [--trace 0] [--out runs.jsonl]

Each set runs every seed once, in order, each run a process of its own
(``benchmark/run.py``); a set's spread of a metric is the distance between
the first and third quartiles (``statistics.quantiles(values, n=4)``) over
its median. Every result line (or the end of a failed run's output) is
appended to ``--out``.
"""
import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def spread(values):
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2 if q2 else float("nan")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--sets", type=int, default=1)
    p.add_argument("--seconds", type=float, default=None)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    seconds = args.seconds
    if seconds is None:
        seconds = json.loads((ROOT / "BENCHMARK.json").read_text())[
            "run_seconds"]
    seeds = [int(s) for s in args.seeds.split(",")]
    sets = []
    for k in range(args.sets):
        rows = []
        for seed in seeds:
            cmd = [sys.executable, "benchmark/run.py", "--workload",
                   args.workload, "--seed", str(seed), "--seconds",
                   str(seconds), "--trace", str(args.trace)]
            t = time.perf_counter()
            proc = subprocess.run(cmd, cwd=ROOT, capture_output=True,
                                  text=True, check=False)
            wall = time.perf_counter() - t
            line = proc.stdout.strip().splitlines()[-1:] if proc.stdout \
                else []
            rec = {"set": k, "seed": seed, "rc": proc.returncode,
                   "wall_s": wall}
            try:
                rec["result"] = json.loads(line[0]) if line else None
            except ValueError:
                rec["result"] = None
            if proc.returncode != 0 or rec["result"] is None:
                rec["stderr"] = proc.stderr[-3000:]
                rec["stdout"] = proc.stdout[-2000:]
            rows.append(rec)
            if args.out:
                Path(args.out).parent.mkdir(parents=True, exist_ok=True)
                with open(args.out, "a") as f:
                    f.write(json.dumps(rec) + "\n")
            r = rec["result"] or {}
            print(f"set {k} seed {seed} rc {proc.returncode} wall "
                  f"{wall:.1f} correct {r.get('correct')} "
                  f"{json.dumps({m: v['value'] for m, v in r.get('metrics', {}).items()})} "
                  f"check {json.dumps({m: v['value'] for m, v in r.get('check', {}).items()})}",
                  flush=True)
            if rec.get("stderr"):
                print(rec["stderr"][-1500:], flush=True)
        sets.append(rows)
    for k, rows in enumerate(sets):
        ok = [r["result"] for r in rows if r["result"]]
        names = sorted({m for r in ok for m in r["metrics"]})
        for m in names:
            vals = [r["metrics"][m]["value"] for r in ok
                    if m in r["metrics"]]
            if len(vals) >= 2:
                print(f"set {k} {m}: median {statistics.median(vals)!r} "
                      f"spread {spread(vals):.5f} n {len(vals)} "
                      f"values {vals}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
