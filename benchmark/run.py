#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout of the repository on a machine with the
cards the cell asks for. The last line of standard output is one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` also ``breakdown``; ``check`` last: each number held
against the reference, beside its limit); the last lines of standard
error repeat the numbers checked. Without a card, with an ``M2S_*``
variable set, outside a checkout, or when a guard fails, it exits
non-zero and prints no result.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# Every cache a run may fill lives at a fixed path inside the checkout.
CACHE = BENCH / "out" / "cache"
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = str(CACHE / sub)
sys.path.insert(0, str(ROOT))


def _card_line() -> str:
    """The first card's name and power limit (``nvidia-smi``)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"not read: {e}"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from benchmark.harness import guards, manifest

    try:
        guards.check_env()
        cell = manifest.find_cell(manifest.load(ROOT), args.workload, BENCH)
        guards.check_card(cell.chips)
        from benchmark.harness import cell as run

        result = run.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), t0=T0, root=ROOT)
    except (guards.GuardError, KeyError, FileNotFoundError) as e:
        print(f"benchmark: {type(e).__name__}: {e}", file=sys.stderr)
        return 1
    check = result.pop("check")
    result["card"] = _card_line()
    result["check"] = check
    for name, c in check.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
