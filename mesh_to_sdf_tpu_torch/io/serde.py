"""Versioned SDF serialization (msgpack container).

Capability parity with the reference serde subsystem
(`mesh_to_sdf/src/serde.rs`): a versioned envelope
(`serde.rs:108-112,149-155` — ``SerializeVersion::V1``), two payload kinds
(`serde.rs:77-104` — ``SerializeSdf::{Generic, Grid}``), file helpers
(`serde.rs:192-221` — ``save_to_file`` / ``read_from_file``), and golden-file
backward-compatibility tests (`serde.rs:315-374`).

Design notes (TPU-first, not a byte-port of rmp-serde):
- arrays are framed as raw little-endian buffers with explicit dtype/shape so
  loads are a single zero-copy ``np.frombuffer`` — no per-element msgpack
  decode on the host (the reference pays rmp per-float costs; we do not);
- the envelope is a msgpack map with a ``version`` int; readers accept any
  known version and fail loudly on unknown ones, mirroring the reference's
  ``DeserializeVersion`` enum contract;
- a native C++ codec for the same format lives in ``native/`` (used when
  built; this module is the always-available fallback and the format spec).

Interop: :func:`loads` / :func:`read_from_file` auto-detect and read the
*reference crate's* rmp-serde V1 containers (``serde.rs:77-155``) —
``{"V1": {"Generic": [points, distances]}}`` with structs encoded as msgpack
arrays — byte-validated against the crate's committed golden files
(``mesh_to_sdf/tests/sdf_{generic,grid}_v1.bin``). :func:`dumps_reference`
writes that format so SDFs round-trip with the Rust crate.

PyTorch port: the payloads may be torch tensors on any device (a
``generate_grid_sdf`` result lies on the card); :func:`_host` detaches them
and brings them to the host before they are framed. The container (magic,
version, layout) is the JAX package's, so either package reads the other's
files.
"""
from __future__ import annotations

import io as _io
from dataclasses import dataclass
from typing import Optional, Tuple, Union

import msgpack
import numpy as np
import torch

from ..grid import Grid

#: Current container version (reference: `serde.rs:108-112`).
VERSION = 1

_MAGIC = "mesh_to_sdf_tpu"

KIND_GENERIC = "generic"
KIND_GRID = "grid"


class SerdeError(ValueError):
    """Raised on malformed or unsupported containers."""


def _host(x):
    """``x`` as a host array: a torch tensor (any device, any grad state)
    detached and copied to the CPU, anything else as it is."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return x


def _pack_array(arr: np.ndarray) -> dict:
    arr = np.ascontiguousarray(arr)
    if arr.dtype.byteorder == ">":
        arr = arr.astype(arr.dtype.newbyteorder("<"))
    return {
        "dtype": arr.dtype.str,
        "shape": list(arr.shape),
        "data": arr.tobytes(),
    }


def _unpack_array(obj: dict) -> np.ndarray:
    try:
        dtype = np.dtype(obj["dtype"])
        shape = tuple(obj["shape"])
        data = obj["data"]
    except (KeyError, TypeError) as e:
        raise SerdeError(f"malformed array record: {e}") from e
    arr = np.frombuffer(data, dtype=dtype)
    return arr.reshape(shape)


@dataclass(frozen=True)
class GenericSdf:
    """`SerializeSdf::Generic` (`serde.rs:83-92`): scattered query points."""

    query_points: np.ndarray  # (Q, 3) float32
    distances: np.ndarray  # (Q,) float32


@dataclass(frozen=True)
class GridSdf:
    """`SerializeSdf::Grid` (`serde.rs:93-104`): a grid and its distances
    (flattened in the reference x-major/z-fastest layout)."""

    grid: Grid
    distances: np.ndarray  # (nx*ny*nz,) float32


Sdf = Union[GenericSdf, GridSdf]


def dumps(sdf: Sdf) -> bytes:
    """Serialize an SDF into the versioned container (`serde.rs:181-190`)."""
    if isinstance(sdf, GenericSdf):
        q = np.asarray(_host(sdf.query_points), np.float32).reshape(-1, 3)
        d = np.asarray(_host(sdf.distances), np.float32).reshape(-1)
        if q.shape[0] != d.shape[0]:
            raise SerdeError(
                f"query_points ({q.shape[0]}) and distances ({d.shape[0]}) disagree"
            )
        payload = {
            "kind": KIND_GENERIC,
            "query_points": _pack_array(q),
            "distances": _pack_array(d),
        }
    elif isinstance(sdf, GridSdf):
        g = sdf.grid
        d = np.asarray(_host(sdf.distances), np.float32).reshape(-1)
        nx, ny, nz = g.cell_count
        if d.size != nx * ny * nz:
            raise SerdeError(
                f"distances size {d.size} != cell count {nx * ny * nz}"
            )
        payload = {
            "kind": KIND_GRID,
            "grid": {
                "first_cell": np.asarray(_host(g.first_cell),
                                         np.float32).tolist(),
                "cell_size": np.asarray(_host(g.cell_size),
                                        np.float32).tolist(),
                "cell_count": [int(nx), int(ny), int(nz)],
            },
            "distances": _pack_array(d),
        }
    else:
        raise SerdeError(f"unknown SDF payload type {type(sdf)!r}")

    envelope = {"magic": _MAGIC, "version": VERSION, "sdf": payload}
    return msgpack.packb(envelope, use_bin_type=True)


def dumps_reference(sdf: Sdf) -> bytes:
    """Serialize into the *reference crate's* rmp-serde V1 container.

    Matches ``rmp_serde::to_vec(&SerializeVersion::V1(sdf))``
    (`serde.rs:77-155,162-166`): enums as single-entry maps, structs and
    points as arrays, floats as f32 — byte-compatible with the crate's own
    output (asserted against its golden files in tests/test_serde.py).
    """
    if isinstance(sdf, GenericSdf):
        q = np.asarray(_host(sdf.query_points), np.float32).reshape(-1, 3)
        d = np.asarray(_host(sdf.distances), np.float32).reshape(-1)
        if q.shape[0] != d.shape[0]:
            raise SerdeError(
                f"query_points ({q.shape[0]}) and distances ({d.shape[0]}) disagree"
            )
        body = {"Generic": [q.tolist(), d.tolist()]}
    elif isinstance(sdf, GridSdf):
        g = sdf.grid
        d = np.asarray(_host(sdf.distances), np.float32).reshape(-1)
        nx, ny, nz = (int(c) for c in g.cell_count)
        if d.size != nx * ny * nz:
            raise SerdeError(
                f"distances size {d.size} != cell count {nx * ny * nz}"
            )
        body = {
            "Grid": [
                [
                    np.asarray(_host(g.first_cell), np.float32).tolist(),
                    np.asarray(_host(g.cell_size), np.float32).tolist(),
                    [nx, ny, nz],
                ],
                d.tolist(),
            ]
        }
    else:
        raise SerdeError(f"unknown SDF payload type {type(sdf)!r}")
    return msgpack.packb({"V1": body}, use_bin_type=True, use_single_float=True)


def _loads_reference(envelope) -> Sdf:
    """Decode an already-unpacked reference-crate V1 container
    (`serde.rs:77-155`)."""
    body = envelope["V1"]
    if not isinstance(body, dict) or len(body) != 1:
        raise SerdeError("malformed reference V1 payload")
    (kind, value), = body.items()
    try:
        if kind == "Generic":
            points, distances = value
            q = np.asarray(points, np.float32).reshape(-1, 3)
            d = np.asarray(distances, np.float32).reshape(-1)
            if q.shape[0] != d.shape[0]:
                raise SerdeError("inconsistent generic payload shapes")
            return GenericSdf(query_points=q, distances=d)
        if kind == "Grid":
            (first_cell, cell_size, cell_count), distances = value
            grid = Grid.new(first_cell, cell_size, [int(c) for c in cell_count])
            d = np.asarray(distances, np.float32).reshape(-1)
            if d.size != grid.total_cell_count:
                raise SerdeError("grid distances size mismatch")
            return GridSdf(grid=grid, distances=d)
    except SerdeError:
        raise
    except Exception as e:  # noqa: BLE001 — shape/type errors in the payload
        raise SerdeError(f"malformed reference {kind} payload: {e}") from e
    raise SerdeError(f"unknown reference sdf kind {kind!r}")


def loads(buf: bytes) -> Sdf:
    """Deserialize a container, accepting any known version
    (`serde.rs:149-178`). Auto-detects both this framework's container and
    the reference crate's rmp-serde V1 format."""
    try:
        envelope = msgpack.unpackb(buf, raw=False)
    except Exception as e:  # noqa: BLE001 — msgpack raises various types
        raise SerdeError(f"not a msgpack container: {e}") from e
    if isinstance(envelope, dict) and set(envelope) == {"V1"}:
        return _loads_reference(envelope)
    if not isinstance(envelope, dict) or envelope.get("magic") != _MAGIC:
        raise SerdeError("missing container magic")
    version = envelope.get("version")
    if version != VERSION:
        raise SerdeError(
            f"unsupported container version {version!r} (supported: {VERSION})"
        )
    payload = envelope.get("sdf")
    if not isinstance(payload, dict):
        raise SerdeError("missing sdf payload")
    kind = payload.get("kind")
    if kind == KIND_GENERIC:
        q = _unpack_array(payload["query_points"]).astype(np.float32)
        d = _unpack_array(payload["distances"]).astype(np.float32)
        if q.ndim != 2 or q.shape[1] != 3 or d.ndim != 1 or q.shape[0] != d.shape[0]:
            raise SerdeError("inconsistent generic payload shapes")
        return GenericSdf(query_points=q, distances=d)
    if kind == KIND_GRID:
        graw = payload["grid"]
        grid = Grid.new(
            graw["first_cell"], graw["cell_size"], graw["cell_count"]
        )
        d = _unpack_array(payload["distances"]).astype(np.float32).reshape(-1)
        if d.size != grid.total_cell_count:
            raise SerdeError("grid distances size mismatch")
        return GridSdf(grid=grid, distances=d)
    raise SerdeError(f"unknown sdf kind {kind!r}")


def save_to_file(path, sdf: Sdf, *, format: str = "native") -> None:
    """`save_to_file` (`serde.rs:192-204`).

    ``format="native"`` writes this framework's zero-copy container;
    ``format="reference"`` writes the Rust crate's rmp-serde V1 format for
    interchange with it.
    """
    if format == "native":
        data = dumps(sdf)
    elif format == "reference":
        data = dumps_reference(sdf)
    else:
        raise SerdeError(f"unknown format {format!r} (native|reference)")
    with open(path, "wb") as f:
        f.write(data)


def read_from_file(path) -> Sdf:
    """`read_from_file` (`serde.rs:207-221`)."""
    with open(path, "rb") as f:
        return loads(f.read())
