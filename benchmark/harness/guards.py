"""What every run checks besides its answers: the environment, the card,
the builds, the route the calls took and the modules the process loaded.
A run that fails one of these exits non-zero and prints no result."""
from __future__ import annotations

import os
import pkgutil
import subprocess
import sys
from pathlib import Path

#: Top-level module names no run may hold once its window has closed:
#: JAX and the JAX package (compared whole: the port's own name begins
#: with the JAX package's).
FORBIDDEN = ("jax", "jaxlib", "flax", "mesh_to_sdf_tpu")
#: The measured package.
PORT = "mesh_to_sdf_tpu_torch"


class GuardError(RuntimeError):
    """A run that cannot stand: the message says why."""


def check_env(environ=os.environ) -> None:
    """No ``M2S_*`` variable: each one switches a path or a constant of
    the port away from what the configuration states."""
    bad = sorted(k for k in environ if k.startswith("M2S_"))
    if bad:
        raise GuardError(f"M2S_* variables set: {bad}")


def check_card(chips: int) -> None:
    import torch

    if not torch.cuda.is_available():
        raise GuardError("no CUDA device: torch.cuda.is_available() is "
                         "false")
    if torch.cuda.device_count() < chips:
        raise GuardError(f"the cell needs {chips} cards, "
                         f"{torch.cuda.device_count()} present")


def forbidden_modules(modules=None) -> list:
    """The loaded modules whose top-level name is one of
    :data:`FORBIDDEN`."""
    names = sys.modules if modules is None else modules
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


def check_imports(modules=None) -> None:
    found = forbidden_modules(modules)
    if found:
        raise GuardError(f"the process holds forbidden modules: {found}")


def build_native(root: Path) -> None:
    """``make -C native`` in the checkout (a no-op once built), then the
    port must find the library: without it the CPT seed bins take their
    numpy fallback, which is not the path the cells measure."""
    native_dir = Path(root) / "native"
    if not (native_dir / "Makefile").is_file():
        raise GuardError(f"no {native_dir}/Makefile: not a checkout of the "
                         "repository")
    proc = subprocess.run(["make", "-C", str(native_dir), "libm2s.so"],
                          capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise GuardError(f"make -C native failed:\n{proc.stdout}"
                         f"{proc.stderr}")
    from mesh_to_sdf_tpu_torch import native

    if not native.available():
        raise GuardError("native/libm2s.so did not load")


def import_port(root: Path):
    """The port, imported from this checkout and no other place."""
    import importlib

    try:
        port = importlib.import_module(PORT)
    except ImportError as e:
        raise GuardError(f"cannot import {PORT}: {e}") from e
    where = Path(port.__file__).resolve()
    if Path(root).resolve() not in where.parents:
        raise GuardError(f"{PORT} loaded from {where}, outside {root}")
    return port


def launch_counters() -> dict:
    """Every ``LaunchCount`` of the port's kernel modules, by
    ``<module>.<attribute>`` (found, not listed: a new kernel's counter
    is held too)."""
    import importlib

    from mesh_to_sdf_tpu_torch.ops import kernels
    from mesh_to_sdf_tpu_torch.ops.kernels import _build

    out = {}
    for info in pkgutil.iter_modules(kernels.__path__):
        mod = importlib.import_module(f"{kernels.__name__}.{info.name}")
        for attr, val in vars(mod).items():
            if isinstance(val, _build.LaunchCount):
                short = mod.__name__.removeprefix(PORT + ".")
                out[f"{short}.{attr}"] = val
    return out


def snapshot(counters: dict) -> dict:
    return {k: (c.kernel, c.plain) for k, c in counters.items()}


def launch_delta(before: dict, after: dict) -> dict:
    """(kernel launches, plain calls) per counter between two
    :func:`snapshot` s."""
    return {k: (after[k][0] - before[k][0], after[k][1] - before[k][1])
            for k in after}


def check_route(per_call: list, route: dict) -> None:
    """Every call launched at least ``route["min_launches_per_call"]`` of
    each named kernel, and no call ran a plain (CPU) version of any."""
    need = route.get("min_launches_per_call", {})
    for i, delta in enumerate(per_call):
        plain = {k: p for k, (_, p) in delta.items() if p}
        if plain:
            raise GuardError(f"call {i} ran plain versions: {plain}")
        short = {k: delta.get(k, (0, 0))[0] for k, n in need.items()
                 if delta.get(k, (0, 0))[0] < n}
        if short:
            raise GuardError(
                f"call {i} left the {route.get('strategy')} route: "
                f"launches {short}, each needs {need}")
