"""The general traffic generator: every call's inputs, made from the seed
in set-up, from a mix's data file (``traffic/<mix>.json``) and the
configuration's mesh recipe.

A mix file holds only parameters:

- ``mesh``: ``per_call`` is ``"same"`` (one mesh, every call; its
  ``vertices`` are ``"device"``, a tensor on the card made once, or
  ``"host"``, numpy) or ``"new"`` (a mesh no call has seen, as numpy: the
  configuration's mesh under a seeded rotation, and a scale from
  ``scale`` = [lo, hi] that does not depend on the seed, see
  :func:`scales`); a ``"new"`` mix makes ``meshes_per_second`` times the
  window's seconds meshes, and ``warm_meshes`` more for set-up.
- ``points`` (optional): ``count`` query points per call, ``pool`` draws
  held on the device and used in turn, and ``components``, each a
  ``share`` of the count: ``surface_gaussian`` (area-weighted points on
  the mesh plus isotropic Gaussian noise of per-axis ``variance``) or
  ``uniform_box`` (uniform in [``lo``, ``hi``]). Shares give every seed
  the same sizes; the last component takes what rounding leaves.
- ``output``: ``"device"`` or ``"host"`` (the field is copied to host
  memory inside the call).
"""
from __future__ import annotations

import hashlib
import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch


class OutOfInputs(RuntimeError):
    """The window asked for more calls than set-up made inputs for."""


def derive(seed: int, tag: str) -> int:
    """A 63-bit seed for one use (``tag``) of the run's ``--seed``: any
    whole number, negative or past 64 bits included."""
    h = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(h[:8], "little") & ((1 << 63) - 1)


def icosphere(subdiv: int, radius: float = 1.0):
    """Watertight icosphere, vectorised: (vertices (V, 3) float32, faces
    (20·4^subdiv, 3) int64), each new vertex an edge's midpoint pushed to
    the sphere in float64."""
    t = (1.0 + math.sqrt(5.0)) / 2.0
    v = np.array([[-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
                  [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
                  [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]],
                 np.float64)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    f = np.array([[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10],
                  [0, 10, 11], [1, 5, 9], [5, 11, 4], [11, 10, 2],
                  [10, 7, 6], [7, 1, 8], [3, 9, 4], [3, 4, 2], [3, 2, 6],
                  [3, 6, 8], [3, 8, 9], [4, 9, 5], [2, 4, 11], [6, 2, 10],
                  [8, 6, 7], [9, 8, 1]], np.int64)
    for _ in range(subdiv):
        e = np.stack([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]], axis=1)
        key = np.sort(e, axis=2).reshape(-1, 2)
        uniq, inv = np.unique(key, axis=0, return_inverse=True)
        mid = v[uniq[:, 0]] + v[uniq[:, 1]]
        mid /= np.linalg.norm(mid, axis=1, keepdims=True)
        m = len(v) + inv.reshape(-1, 3)  # midpoints of (ab, bc, ca)
        ab, bc, ca = m[:, 0], m[:, 1], m[:, 2]
        a, b, c = f[:, 0], f[:, 1], f[:, 2]
        f = np.stack([np.stack([a, ab, ca], 1), np.stack([b, bc, ab], 1),
                      np.stack([c, ca, bc], 1), np.stack([ab, bc, ca], 1)],
                     axis=1).reshape(-1, 3)
        v = np.concatenate([v, mid])
    return (v * radius).astype(np.float32), f


def make_mesh(spec: dict):
    """(vertices (V, 3) float32, faces (F, 3) int64) of a configuration's
    mesh recipe."""
    if spec["kind"] == "icosphere":
        return icosphere(int(spec["subdiv"]), float(spec.get("radius", 1.0)))
    raise ValueError(f"unknown mesh kind {spec['kind']!r}")


def rotations(rng: np.random.Generator, n: int) -> np.ndarray:
    """``n`` rotation matrices drawn uniformly (QR of Gaussian matrices,
    signs fixed so each has determinant +1)."""
    q, r = np.linalg.qr(rng.standard_normal((n, 3, 3)))
    q = q * np.sign(np.diagonal(r, axis1=1, axis2=2))[:, None, :]
    flip = np.linalg.det(q) < 0
    q[flip, :, 0] *= -1.0
    return q


def scales(n: int, lo: float, hi: float) -> np.ndarray:
    """``n`` scales spread over [lo, hi] by the golden-ratio sequence, the
    same for every seed: every seed's window sees the same sizes in the
    same order (the seed draws only the rotations), so the work and the
    memory a window needs do not move with the seed."""
    golden = (math.sqrt(5.0) - 1.0) / 2.0
    return lo + (hi - lo) * np.mod(np.arange(n) * golden, 1.0)


def new_meshes(v: np.ndarray, rot: np.ndarray, scale: np.ndarray, device,
               chunk: int = 256) -> np.ndarray:
    """(n, V, 3) float32 numpy: ``v`` under each rotation ``rot[k]`` times
    ``scale[k]``, computed on ``device`` a chunk of meshes at a time by
    elementwise products (no matmul, so no TF32 and no reduction order
    that varies) and copied into one host array."""
    n = len(rot)
    out = np.empty((n, len(v), 3), np.float32)
    base = torch.from_numpy(v).to(device)
    r = torch.from_numpy(rot * scale[:, None, None]).to(device,
                                                        torch.float32)
    for a in range(0, n, chunk):
        rk = r[a:a + chunk]  # (c, 3, 3): rows k, columns j
        x = (base[None, :, None, 0] * rk[:, None, :, 0]
             + base[None, :, None, 1] * rk[:, None, :, 1]
             + base[None, :, None, 2] * rk[:, None, :, 2])
        torch.from_numpy(out[a:a + chunk]).copy_(x)
    return out


def _counts(total: int, shares) -> list:
    counts = [int(math.floor(s * total)) for s in shares[:-1]]
    return counts + [total - sum(counts)]


def surface_points(tris: torch.Tensor, n: int, gen: torch.Generator):
    """``n`` points on the (T, 3, 3) triangles, area-weighted."""
    a, b, c = tris[:, 0], tris[:, 1], tris[:, 2]
    area = 0.5 * torch.linalg.norm(torch.cross(b - a, c - a, dim=1), dim=1)
    idx = torch.multinomial(area, n, replacement=True, generator=gen)
    u = torch.rand((n, 2), generator=gen, device=tris.device)
    su = torch.sqrt(u[:, :1])
    w1 = su * (1.0 - u[:, 1:])
    w2 = su * u[:, 1:]
    return (1.0 - su) * a[idx] + w1 * b[idx] + w2 * c[idx]


def make_points(spec: dict, tris: torch.Tensor, gen: torch.Generator):
    """One draw of ``spec["count"]`` query points, (count, 3) float32 on
    the triangles' device, the components shuffled together."""
    comps = spec["components"]
    dev = tris.device
    parts = []
    for comp, n in zip(comps, _counts(int(spec["count"]),
                                      [c["share"] for c in comps])):
        if comp["kind"] == "surface_gaussian":
            p = surface_points(tris, n, gen)
            p = p + math.sqrt(float(comp["variance"])) * torch.randn(
                (n, 3), generator=gen, device=dev)
        elif comp["kind"] == "uniform_box":
            lo = torch.tensor(comp["lo"], dtype=torch.float32, device=dev)
            hi = torch.tensor(comp["hi"], dtype=torch.float32, device=dev)
            p = lo + (hi - lo) * torch.rand((n, 3), generator=gen,
                                            device=dev)
        else:
            raise ValueError(f"unknown component {comp['kind']!r}")
        parts.append(p)
    pts = torch.cat(parts)
    perm = torch.randperm(pts.shape[0], generator=gen, device=dev)
    return pts[perm].contiguous()


@dataclass
class Feed:
    """Every call's inputs. ``faces`` is shared by every mesh; call ``i``
    of the window takes :meth:`vertices` and :meth:`queries` of ``i``,
    warm-up call ``j`` those of ``-1 - j``."""

    faces: np.ndarray
    base_vertices: np.ndarray
    mesh_vertices: object  # one mesh (array or tensor), or a (n, V, 3) stack
    per_call: str
    warm: int
    pool: Optional[list]
    output: str

    def mesh_index(self, i: int) -> int:
        """Which of the made meshes call ``i`` (warm-up: ``i < 0``) takes."""
        if self.per_call == "same":
            return 0
        j = (-1 - i) if i < 0 else self.warm + i
        if j >= len(self.mesh_vertices):
            raise OutOfInputs(
                f"call {i} needs mesh {j}; set-up made "
                f"{len(self.mesh_vertices)}")
        return j

    def vertices(self, i: int):
        if self.per_call == "same":
            return self.mesh_vertices
        return self.mesh_vertices[self.mesh_index(i)]

    def host_vertices(self, i: int) -> np.ndarray:
        """The vertices of call ``i`` as numpy, for the reference."""
        v = self.vertices(i)
        return v.cpu().numpy() if isinstance(v, torch.Tensor) else v

    def pool_index(self, i: int) -> int:
        return (-1 - i) % len(self.pool) if i < 0 else i % len(self.pool)

    def queries(self, i: int):
        return None if self.pool is None else self.pool[self.pool_index(i)]


def make_feed(traffic: dict, mesh_spec: dict, seed: int, device,
              seconds: float) -> Feed:
    """The feed of one run: ``traffic`` (a mix file's contents) on the
    configuration's ``mesh_spec``, from ``seed``, for a window of
    ``seconds``."""
    device = torch.device(device)
    v, f = make_mesh(mesh_spec)
    m = traffic["mesh"]
    per_call = m.get("per_call", "same")
    warm = 0
    if per_call == "same":
        verts = (torch.from_numpy(v).to(device) if m.get("vertices") ==
                 "device" else v)
    elif per_call == "new":
        warm = int(m.get("warm_meshes", 2))
        n = warm + int(math.ceil(float(m["meshes_per_second"]) * seconds)) + 8
        rng = np.random.default_rng(derive(seed, "meshes"))
        verts = new_meshes(v, rotations(rng, n),
                           scales(n, *m.get("scale", [1.0, 1.0])), device)
    else:
        raise ValueError(f"unknown mesh per_call {per_call!r}")
    pool = None
    if "points" in traffic:
        spec = traffic["points"]
        gen = torch.Generator(device=device)
        gen.manual_seed(derive(seed, "points"))
        tris = torch.from_numpy(v[f]).to(device)
        pool = [make_points(spec, tris, gen) for _ in range(int(spec["pool"]))]
    return Feed(faces=f, base_vertices=v, mesh_vertices=verts,
                per_call=per_call, warm=warm, pool=pool,
                output=traffic.get("output", "device"))
