"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` for Hopper
(``sm_90a``), all started together, and the objects are linked into one
shared library with a plain C interface, loaded with ctypes. The library
is built at first use into ``mesh_to_sdf_tpu_torch/_build/`` (not under
version control), keyed by a hash of the sources and flags, so a checkout
builds everything it needs on its first kernel call.

Nothing here runs at import: the CPU-only test host has no ``nvcc``, and
its tensors take the plain PyTorch versions, which never reach this module.
"""
from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from dataclasses import dataclass
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

#: -fmad=false keeps every multiply and add separately rounded, as the plain
#: PyTorch versions (and the TPU kernels' CPU interpret mode) compute them.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v",
)

_lib = None
_lock = threading.Lock()


@dataclass
class LaunchCount:
    """Calls that launched a kernel, and calls to its plain version."""

    kernel: int = 0
    plain: int = 0

    def reset(self) -> None:
        self.kernel = 0
        self.plain = 0


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libm2s_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless this exact build exists; return the path
    of the library. One ``nvcc -c`` per source runs in parallel, then one
    link, into files named for this process and thread, and the library is
    moved into place whole. ``nvcc``'s ptxas report (registers, shared
    memory, spills per kernel) is kept beside the library with the suffix
    ``.log``."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(exist_ok=True)
    # Processes that reach a missing library together (ranks of one host)
    # take turns on a file lock; the first builds, the others find its
    # library when their turn comes. The kernel drops the lock when its
    # holder exits, whatever the way.
    with open(path.with_suffix(".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not path.exists():
            _compile(path)
    return path


def _compile(path: Path) -> None:
    tag = f"{path.stem}.{os.getpid()}.{threading.get_ident()}"
    nvcc = _nvcc()
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    report = []
    failed = []
    for cmd, _, proc in jobs:
        out, _ = proc.communicate()
        report.append(out)
        if proc.returncode != 0:
            failed.append(f"nvcc failed (exit {proc.returncode}): "
                          f"{' '.join(cmd)}\n{out}")
    objs = [obj for _, obj, _ in jobs]
    try:
        if failed:
            raise RuntimeError("\n".join(failed))
        tmp = path.with_name(f"{tag}.tmp.so")
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
               "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              check=False)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed (exit {proc.returncode}): "
                f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    path.with_suffix(".log").write_text("".join(report))
    os.replace(tmp, path)


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            handle.m2s_error_string.argtypes = [ctypes.c_int]
            handle.m2s_error_string.restype = ctypes.c_char_p
            _lib = handle
    return _lib


@functools.cache
def entry(name: str, argtypes: tuple):
    """The library's C entry point ``name``, bound with ``argtypes``
    (``c_void_p`` for every pointer and the stream); it returns a
    ``cudaError_t``."""
    fn = getattr(lib(), name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def check(rc: int, name: str) -> None:
    """Raise if the C entry point ``name`` returned a CUDA error."""
    if rc != 0:
        msg = lib().m2s_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")
