"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for Hopper (``sm_90a``) into
one shared library with a plain C interface, loaded with ctypes. The library
is built at first use into ``mesh_to_sdf_tpu_torch/_build/`` (not under
version control), keyed by a hash of the sources and flags, so a checkout
builds everything it needs on its first kernel call.

Nothing here runs at import: the CPU-only test host has no ``nvcc``, and
its tensors take the plain PyTorch versions, which never reach this module.
"""
from __future__ import annotations

import ctypes
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
    "-shared", "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v",
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
    of the library. ``nvcc``'s ptxas report (registers, shared memory,
    spills per kernel) is kept beside it with the suffix ``.log``."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sorted(CSRC.glob("*.cu")))]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}"
        )
    path.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, path)
    return path


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
