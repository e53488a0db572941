"""Core enums and constants for the TPU-native mesh→SDF framework.

Capability parity targets (reference: Azkellas/mesh_to_sdf):
- ``SignMethod`` mirrors `mesh_to_sdf/src/lib.rs:204-216`.
- ``AccelerationMethod`` mirrors `mesh_to_sdf/src/lib.rs:224-239`, but on TPU the
  acceleration choice collapses to *kernel strategy* selection (trees lose to
  tiles on a systolic/vector machine):

  ============================  =====================================================
  reference                     TPU-native strategy
  ============================  =====================================================
  ``None(sign)``                ``Strategy.XLA`` — fused XLA brute force (scan over
                                triangle blocks)
  ``Bvh(sign)``                 ``Strategy.PALLAS`` — tiled Pallas kernel, VMEM-resident
                                triangle blocks
  ``Rtree`` (normal sign only)  ``Strategy.CULLED`` + ``SignMethod.NORMAL``
  ``RtreeBvh`` (raycast)        ``Strategy.CULLED`` + ``SignMethod.RAYCAST`` (default)
  ============================  =====================================================
"""
from __future__ import annotations

import enum
from dataclasses import dataclass

import numpy as np

# f32::MAX — the reference's "no triangle found" sentinel
# (`mesh_to_sdf/src/generate/generic/default.rs:45`).
F32_MAX = float(np.finfo(np.float32).max)


class SignMethod(enum.Enum):
    """How the sign of the distance is computed.

    Mirrors `mesh_to_sdf/src/lib.rs:204-216`:
    - RAYCAST (default): count ray/mesh crossings; robust, needs watertight mesh.
    - NORMAL: dot the direction against the triangle normal; works for open
      surfaces but may leak negative distances outside.
    """

    RAYCAST = "raycast"
    NORMAL = "normal"


class Strategy(enum.Enum):
    """Kernel strategy (the TPU-native analog of acceleration structures)."""

    #: Pure-XLA brute force: scan over triangle blocks, keyed-min reduce.
    XLA = "xla"
    #: Tiled Pallas kernel: query/cell tiles × triangle blocks in VMEM.
    PALLAS = "pallas"
    #: Two-phase tile culling: coarse tile→triangle candidate selection (top-K
    #: by conservative bound), then exact dense min over candidates.
    CULLED = "culled"
    #: Closest-point transform (grids only): seed from triangle AABB windows,
    #: then directional sweeps carrying nearest-triangle state — O(cells+tris),
    #: the TPU redesign of the reference's preheap+BFS flagship
    #: (`generate/grid.rs:234-264`). Same guarantee class as the reference:
    #: exact re-evaluation over propagated candidates (tests assert: never
    #: undershoots, exact within 1.5 cells of the surface, ≤2% relative
    #: deviation far-field).
    CPT = "cpt"
    #: Pick automatically based on problem size and backend.
    AUTO = "auto"


@dataclass(frozen=True)
class AccelerationMethod:
    """Reference-compatible acceleration selector.

    Mirrors `mesh_to_sdf/src/lib.rs:224-239`. Construct via the classmethods —
    e.g. ``AccelerationMethod.rtree_bvh()`` — for drop-in familiarity, or pass a
    :class:`Strategy` directly to the generate functions.
    """

    strategy: Strategy
    sign_method: SignMethod

    @classmethod
    def none(cls, sign_method: SignMethod = SignMethod.RAYCAST) -> "AccelerationMethod":
        return cls(Strategy.XLA, sign_method)

    @classmethod
    def bvh(cls, sign_method: SignMethod = SignMethod.RAYCAST) -> "AccelerationMethod":
        return cls(Strategy.PALLAS, sign_method)

    @classmethod
    def rtree(cls) -> "AccelerationMethod":
        # Reference Rtree only supports the normal sign
        # (`mesh_to_sdf/src/generate/generic/rtree.rs:96-126`).
        return cls(Strategy.CULLED, SignMethod.NORMAL)

    @classmethod
    def rtree_bvh(cls) -> "AccelerationMethod":
        return cls(Strategy.CULLED, SignMethod.RAYCAST)
