"""What every entry point does with its inputs before any engine runs.

- :func:`resolve_device` and :func:`resolve_strategy`: where a call runs
  and which strategy and sign method it asked for; :func:`dense_strategy`,
  the dense route of a device.
- :func:`points_on_host`, :func:`host_soup`, :func:`upload_soup` and
  :func:`prepare_triangles`: the mesh as a host triangle soup and as padded
  tensors on the device.
- :func:`content_key` and :func:`cached`: the one policy of the per-mesh
  caches (the CPT prep, the stream's and the sharded grid's prep, CULLED's
  structures): keyed by the content of the host arrays, a small FIFO each.
"""
from __future__ import annotations

import contextlib
import zlib
from typing import Optional

import numpy as np
import torch

from .topology import Topology, as_points, gather_triangle_vertices
from .types import AccelerationMethod, SignMethod, Strategy
from .utils.profiling import span, sync_span


def resolve_strategy(acceleration, sign_method):
    """(strategy, sign method) of an ``AccelerationMethod``, or of a
    ``Strategy`` (None: AUTO) and a sign method (None: RAYCAST)."""
    if isinstance(acceleration, AccelerationMethod):
        return acceleration.strategy, acceleration.sign_method
    if acceleration is None:
        acceleration = Strategy.AUTO
    if sign_method is None:
        sign_method = SignMethod.RAYCAST
    return acceleration, sign_method


def dense_strategy(device: torch.device) -> Strategy:
    """AUTO's dense route: the fused kernels on a CUDA device (as on the
    TPU), the brute-force engine elsewhere."""
    return Strategy.PALLAS if device.type == "cuda" else Strategy.XLA


def resolve_device(device, *inputs) -> torch.device:
    """Where an entry point runs: ``device`` when given, else the device of
    the first tensor among ``inputs``, else CUDA. Raises when that is CUDA
    and there is none: nothing falls back to the CPU unasked."""
    if device is None:
        device = next((x.device for x in inputs
                       if isinstance(x, torch.Tensor)), "cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' (or CPU "
                           "tensors) to run on the CPU")
    return device


def points_on_host(vertices, sync: str) -> np.ndarray:
    """:func:`as_points` of ``vertices``; a copy from the card is marked as
    the host sync ``sync``."""
    with sync_span(sync, vertices):
        return as_points(vertices)


def host_soup(vertices, topology: Optional[Topology]):
    """(ta, tb, tc) float32 numpy triangle soup of the mesh."""
    v = points_on_host(vertices, "sync.query.vertices")
    if topology is None:
        topology = Topology.triangle_list(None)
    return gather_triangle_vertices(v, topology)


def upload_soup(ta, tb, tc, tri_block: int, device):
    """(ta, tb, tc, valid, T) on ``device``, padded with zero triangles to a
    multiple of ``tri_block`` (``valid`` masks the padding)."""
    T = ta.shape[0]
    pad = (-T) % tri_block if T > 0 else tri_block
    valid = np.ones((T,), bool)
    if pad:
        zeros = np.zeros((pad, 3), np.float32)
        ta = np.concatenate([ta, zeros])
        tb = np.concatenate([tb, zeros])
        tc = np.concatenate([tc, zeros])
        valid = np.concatenate([valid, np.zeros((pad,), bool)])
    out = []
    for sync, x in (("sync.query.upload.ta", ta), ("sync.query.upload.tb", tb),
                    ("sync.query.upload.tc", tc),
                    ("sync.query.upload.valid", valid)):
        x = torch.from_numpy(np.ascontiguousarray(x))
        with sync_span(sync, device):
            out.append(x.to(device))
    return (*out, T)


def prepare_triangles(vertices, topology: Optional[Topology],
                      tri_block: int, device=None):
    """Expand topology → (ta, tb, tc, valid, T): (T', 3) float32 triangle
    vertex tensors on ``device``, padded with zero triangles to a multiple
    of ``tri_block`` (``valid`` masks the padding), and the real count T."""
    return upload_soup(*host_soup(vertices, topology), tri_block, device)


def content_key(*arrays) -> tuple:
    """A cache key of numpy arrays by content: per array the CRC-32 of its
    buffer (read in place when C-contiguous), its shape and its dtype.
    CRC-32, not Adler-32: Adler-32's sums can miss the same bytes moved
    between the columns of every row (faces wound the other way), which
    the NORMAL sign tells apart."""
    return tuple(part for a in arrays
                 for part in (zlib.crc32(np.ascontiguousarray(a)), a.shape,
                              a.dtype.str))


def cached(cache: dict, key, build, max_size: int,
           miss: Optional[str] = None):
    """``cache[key]``, built by ``build()`` on a miss (inside the span
    ``miss`` when given); the oldest entry goes once the cache holds
    ``max_size``."""
    hit = cache.get(key)
    if hit is None:
        with span(miss) if miss else contextlib.nullcontext():
            hit = build()
        if len(cache) >= max_size:
            cache.pop(next(iter(cache)))
        cache[key] = hit
    return hit
