"""BENCHMARK.json: names, units and keys within the benchmark's rules,
and every named file present."""
import copy

import pytest

from benchmark.harness import manifest


@pytest.fixture(scope="module")
def real():
    return manifest.load(manifest.ROOT)


def test_real_manifest_keeps_the_rules(real):
    assert manifest.problems(real, manifest.ROOT) == []


def test_names_and_units_use_allowed_characters(real):
    metrics = real["end_to_end"] + real["per_layer"]
    names = ([c["name"] for c in real["configs"]]
             + [w[k] for w in real["workloads"]
                for k in ("name", "config", "traffic")]
             + [m["name"] for m in metrics]
             + [k for c in real["configs"] for k in c["reduced"]])
    assert all(manifest.NAME_RE.match(n) for n in names)
    assert all(manifest.UNIT_RE.match(m["unit"]) for m in metrics)
    assert all(n.isascii() for n in names)


@pytest.mark.parametrize("where,key,bad", [
    ("workloads", "name", "has space"),
    ("workloads", "name", "a,b"),
    ("workloads", "name", "x/y"),
    ("end_to_end", "name", "μs"),
    ("end_to_end", "unit", "tokens per second"),
    ("per_layer", "unit", "µs"),
    ("configs", "name", "-" + "x" * 70),
])
def test_bad_names_are_found(real, where, key, bad):
    m = copy.deepcopy(real)
    m[where][0][key] = bad
    assert manifest.problems(m)


@pytest.mark.parametrize("edit", [
    lambda m: m["end_to_end"][1].update(bound=0.5),
    lambda m: m["end_to_end"][1].update(bound=0.001),
    lambda m: m["end_to_end"][1].update(why="a why"),
    lambda m: m["per_layer"][0].update(moves="not_a_metric"),
    lambda m: m["workloads"][0].update(chips=2),
    lambda m: m["end_to_end"].pop(0),
    lambda m: m.update(run_seconds=52),
    lambda m: m["per_layer"][0].update(source="a_guess"),
    lambda m: m["workloads"].append(dict(m["workloads"][0], name="twin")),
])
def test_broken_entries_are_found(real, edit):
    m = copy.deepcopy(real)
    edit(m)
    assert manifest.problems(m)


def test_every_cell_finds_its_files(real):
    for w in real["workloads"]:
        cell = manifest.find_cell(real, w["name"])
        assert cell.config["name"] == w["config"]
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)
        assert cell.per_layer
        for m in cell.end_to_end + cell.per_layer:
            assert hasattr(manifest.load_metric(m["name"]), "read")
