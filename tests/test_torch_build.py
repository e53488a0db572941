"""The kernel build (``ops/kernels/_build.py``) under concurrent first use:
processes that reach a missing library together build it once, and every
one of them gets the whole library. ``nvcc`` is faked by a script that logs
its calls, writes its outputs slowly, and a link that writes a marker."""
import os
import stat
import subprocess
import sys
import textwrap
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

FAKE_NVCC = textwrap.dedent("""\
    #!{python}
    import sys, time
    args = sys.argv[1:]
    out = args[args.index("-o") + 1]
    with open({log!r}, "a") as fh:
        fh.write(("link" if "-shared" in args else "compile") + "\\n")
    time.sleep(0.5)
    with open(out, "w") as fh:
        fh.write("library" if "-shared" in args else "object")
    print("ptxas info : Used 1 registers")
""")

BUILDER = textwrap.dedent("""\
    import sys
    from pathlib import Path
    from mesh_to_sdf_tpu_torch.ops.kernels import _build
    _build.BUILD_DIR = Path(sys.argv[1])
    print(_build.build())
""")


def test_concurrent_first_use_builds_once(tmp_path):
    cuda = tmp_path / "cuda"
    (cuda / "bin").mkdir(parents=True)
    log = tmp_path / "nvcc.log"
    nvcc = cuda / "bin" / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable, log=str(log)))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    build_dir = tmp_path / "build"
    env = dict(os.environ, CUDA_HOME=str(cuda), PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen([sys.executable, "-c", BUILDER,
                               str(build_dir)], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = []
    for proc in procs:
        out, err = proc.communicate(timeout=120)
        assert proc.returncode == 0, err
        outs.append(out.strip().splitlines()[-1])
    assert outs[0] == outs[1]
    lib = Path(outs[0])
    assert lib.parent == build_dir and lib.read_text() == "library"
    assert "Used 1 registers" in lib.with_suffix(".log").read_text()
    n_sources = len(list((ROOT / "mesh_to_sdf_tpu_torch" / "csrc")
                         .glob("*.cu")))
    calls = log.read_text().split()
    assert calls.count("compile") == n_sources and calls.count("link") == 1
    # Nothing of the build is left beside the library, its log and lock.
    assert sorted(p.name for p in build_dir.iterdir()) == sorted(
        [lib.name, lib.with_suffix(".log").name,
         lib.with_suffix(".lock").name])
