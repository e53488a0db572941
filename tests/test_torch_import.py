"""The PyTorch port stands alone: it never imports JAX or the JAX package,
and its copied numpy-only modules stay byte-identical to the originals."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "mesh_to_sdf_tpu_torch"


def test_import_pulls_in_no_jax():
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "import mesh_to_sdf_tpu_torch\n"
        "import mesh_to_sdf_tpu_torch.gridgen\n"
        "import mesh_to_sdf_tpu_torch.gridgen_streamed\n"
        "import mesh_to_sdf_tpu_torch.query\n"
        "import mesh_to_sdf_tpu_torch.ops.culling\n"
        "import mesh_to_sdf_tpu_torch.models.sdf_layer\n"
        "import mesh_to_sdf_tpu_torch.models.checkpoint\n"
        "import mesh_to_sdf_tpu_torch.io\n"
        "import mesh_to_sdf_tpu_torch.utils.baseline\n"
        "new = set(sys.modules) - before\n"
        "bad = sorted(m for m in new if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'mesh_to_sdf_tpu'\n"
        "             or m.startswith('mesh_to_sdf_tpu.'))\n"
        "assert not bad, bad\n"
        "assert 'jax' not in sys.modules\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize(
    "path",
    sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_no_jax_import_in_source(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "mesh_to_sdf_tpu"), (path, name)


@pytest.mark.parametrize("rel", ["types.py", "topology.py",
                                 "utils/meshgen.py", "utils/profiling.py",
                                 "utils/__init__.py", "utils/baseline.py",
                                 "io/gltf.py", "io/__init__.py",
                                 "models/__init__.py"])
def test_copied_modules_are_byte_identical(rel):
    assert (PORT / rel).read_bytes() == (
        ROOT / "mesh_to_sdf_tpu" / rel).read_bytes()


def test_public_api():
    import mesh_to_sdf_tpu_torch as tm

    assert set(tm.__all__) == {
        "Grid", "Topology", "AccelerationMethod", "SignMethod", "Strategy",
        "F32_MAX", "generate_grid_sdf", "generate_sdf", "compare_distances",
        "as_points", "__version__",
    }
    for name in tm.__all__:
        assert hasattr(tm, name)
    assert tm.__version__ == "0.1.0"


def test_utils_exports_match_the_jax_package():
    """The port's ``utils`` exports the JAX package's names: the procedural
    meshes and the profiling helpers."""
    from mesh_to_sdf_tpu_torch import utils

    assert set(utils.__all__) == {"LastRunInfo", "PhaseTimer", "logger",
                                  "box", "icosphere", "torus"}
    for name in utils.__all__:
        assert hasattr(utils, name)
    timer = utils.PhaseTimer()
    with timer.phase("a"):
        pass
    assert "a" in timer.times and utils.LastRunInfo(cells=4, seconds=2.0
                                                    ).cells_per_s == 2.0


def test_every_kernel_source_names_what_it_replaces():
    for src in ("sweep.cu", "parity.cu", "sdf.cu", "culled.cu"):
        text = (PORT / "csrc" / src).read_text()
        assert "Replaces the TPU kernel" in text, src
        assert "What bounds it on the H100" in text, src
