#!/usr/bin/env python3
"""Read the control of one cell on several seeds, in one process: the
plain reference, one precision below the configuration's, put in the
program's place at the cell's own sizes, after a short window.

    python3 benchmark/tools/control.py --workload <cell> --seeds 1,2,3 \
        [--seconds 2]

Prints one JSON line per seed with the numbers compared and their limits;
each must come out not correct.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    from benchmark.harness import cell, guards, manifest

    guards.check_env()
    c = manifest.find_cell(manifest.load(ROOT), args.workload)
    guards.check_card(c.chips)
    for seed in (int(s) for s in args.seeds.split(",")):
        r = cell.run_cell(c, seed, args.seconds, False,
                          t0=time.perf_counter(), root=ROOT, control=True)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": r["correct"], "check": r["check"],
                          "check_s": r["run"]["check_s"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
