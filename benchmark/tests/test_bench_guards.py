"""The guards every run applies: the import check, the environment, the
route, and the port's launch counters."""
import subprocess
import sys

import pytest

from benchmark.harness import guards

ROOT = guards.Path(__file__).resolve().parents[2]


@pytest.mark.parametrize("mods,found", [
    (["mesh_to_sdf_tpu_torch", "mesh_to_sdf_tpu_torch.ops.cpt", "torch"],
     []),
    (["mesh_to_sdf_tpu.ops.cpt"], ["mesh_to_sdf_tpu"]),
    (["jax.numpy", "jaxlib.xla_client"], ["jax", "jaxlib"]),
    (["flax.linen"], ["flax"]),
    (["mesh_to_sdf_tpu_extra", "jaxtyping", "xjax"], []),
])
def test_import_check_compares_whole_top_level_names(mods, found):
    assert guards.forbidden_modules(mods) == found
    if found:
        with pytest.raises(guards.GuardError):
            guards.check_imports(mods)
    else:
        guards.check_imports(mods)


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = (
        "import sys, runpy\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "import benchmark.harness.cell, benchmark.entries.grid, "
        "benchmark.entries.query, benchmark.tools\n"
        "from benchmark.harness import manifest\n"
        "m = manifest.load()\n"
        "[manifest.load_metric(x['name']) for x in "
        "m['end_to_end'] + m['per_layer']]\n"
        "import mesh_to_sdf_tpu_torch.gridgen, mesh_to_sdf_tpu_torch.query\n"
        "from benchmark.harness import guards\n"
        "guards.launch_counters()\n"
        "print(guards.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd="/")
    assert out.stdout.strip() == "[]", out.stdout + out.stderr


def test_the_reference_imports_nothing_of_the_port():
    code = (f"import sys; sys.path.insert(0, {str(ROOT)!r})\n"
            "import benchmark.reference.exact, benchmark.roofline_frozen\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('mesh_to_sdf_tpu_torch', 'mesh_to_sdf_tpu', 'jax')))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd="/")
    assert out.stdout.strip() == "[]", out.stdout + out.stderr


def test_m2s_variables_are_refused():
    guards.check_env({"PATH": "/bin", "BENCH_RUN": "x"})
    with pytest.raises(guards.GuardError):
        guards.check_env({"M2S_CULLED_ENGINE": "union"})


def test_launch_counters_are_found():
    names = set(guards.launch_counters())
    assert {"ops.kernels.sweep.COUNT", "ops.kernels.parity.COUNT",
            "ops.kernels.culled.COUNT",
            "ops.kernels.sdf.RAYCAST_COUNT"} <= names


def test_route_check():
    route = {"strategy": "CPT",
             "min_launches_per_call": {"ops.kernels.sweep.COUNT": 6}}
    ok = {"ops.kernels.sweep.COUNT": (6, 0), "ops.kernels.sdf.X": (0, 0)}
    guards.check_route([ok, ok], route)
    with pytest.raises(guards.GuardError, match="left the CPT route"):
        guards.check_route([ok, {"ops.kernels.sweep.COUNT": (5, 0)}],
                           route)
    with pytest.raises(guards.GuardError, match="plain"):
        guards.check_route([dict(ok, **{"ops.kernels.sdf.X": (0, 1)})],
                           route)


def test_a_directory_without_the_checkout_is_refused(tmp_path):
    with pytest.raises(guards.GuardError):
        guards.build_native(tmp_path)
