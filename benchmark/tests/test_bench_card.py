"""On the card, at each cell's own size: the control (the reference one
precision below the configuration's, in the program's place) and each
fault a cell can have (answers altered where the port produces them: a
distance moved, a sign flipped) come out not correct; a clean short run
comes out correct. Run on a machine with an NVIDIA GPU:

    python3 -m pytest benchmark/tests/test_bench_card.py -m cuda
"""
import time

import pytest
import torch

import mesh_to_sdf_tpu_torch as tm
from benchmark.harness import cell as run
from benchmark.harness import manifest

pytestmark = pytest.mark.cuda

CELLS = [w["name"] for w in manifest.load()["workloads"]]
SEEDS = (2**31 + 11, 2**31 + 12, 2**31 + 13)


def _cell(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return manifest.find_cell(manifest.load(), name)


def _run(c, seed, **kw):
    return run.run_cell(c, seed, 1.0, False, t0=time.perf_counter(), **kw)


@pytest.mark.parametrize("name", CELLS)
def test_clean_run_is_correct(name):
    r = _run(_cell(name), SEEDS[0])
    assert r["correct"], r["check"]


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    c = _cell(name)
    for seed in SEEDS:
        r = _run(c, seed, control=True)
        assert not r["correct"], (seed, r["check"])


@pytest.mark.parametrize("how", ["offset", "sign"])
@pytest.mark.parametrize("name", CELLS)
def test_altered_answers_are_not_correct(name, how, monkeypatch):
    c = _cell(name)
    for entry in ("generate_grid_sdf", "generate_sdf"):
        fn = getattr(tm, entry)

        def broken(*args, _fn=fn, **kwargs):
            out = _fn(*args, **kwargs).clone()
            flat = out.view(-1)
            if how == "offset":
                flat[::100] += 0.01
            else:
                flat[::100] *= -1.0
            return out

        monkeypatch.setattr(tm, entry, broken)
    r = _run(c, SEEDS[1])
    assert not r["correct"], r["check"]
