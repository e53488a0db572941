"""Process meshes over ``torch.distributed`` (PyTorch counterpart of
``parallel/mesh.py``).

The JAX package runs one controller over a device ``Mesh``; here every rank
is a process of its own (SPMD) and the mesh is a ``DeviceMesh`` over the
process group's ranks, row-major, with two dimensions:

- ``cells``: the data-parallel axis: query points and grid cells are split
  over it;
- ``tris``: the reduction axis: triangle blocks are split over it and each
  query's champions are min-reduced across it.

The JAX collectives become explicit collectives on the mesh's sub-groups
(the private helpers below): ``all_gather`` + ``min`` over ``tris`` is
:func:`_gather_min`, ``psum`` over ``tris`` is :func:`_psum`, ``ppermute``
over ``cells`` is :func:`_exchange` (real neighbours only), and the vertex
gradient's ``psum`` that ``shard_map``'s transpose inserts is an explicit
:func:`_all_reduce_` over the world.

The backend follows the devices: ``nccl`` when each rank has a card of its
own, ``gloo`` on the CPU and for several ranks that share one card (NCCL
refuses two ranks on one GPU). Gloo's collectives here take host tensors,
so a collective on CUDA tensors over a gloo group goes through host memory;
which one runs is read from ``dist.get_backend(group)``.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

from ..intake import resolve_device

CELL_AXIS = "cells"
TRI_AXIS = "tris"


def _backend_for(device_type: str, local_world: int) -> str:
    """``nccl`` when every local rank has a card of its own, else ``gloo``."""
    if device_type == "cuda" and local_world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def initialize_distributed(init_method: Optional[str] = None,
                           world_size: Optional[int] = None,
                           rank: Optional[int] = None, *,
                           device_type: str = "cuda") -> None:
    """Join (or make) the default process group.

    - a group that already exists is used as it is;
    - ``init_method`` (``tcp://host:port``, ``file:///path``) with
      ``world_size`` and ``rank`` as given;
    - else with torchrun's environment (``RANK``, ``WORLD_SIZE``,
      ``MASTER_ADDR``): ``env://``;
    - else a world of 1 over an in-process ``dist.HashStore``.

    Backend ``nccl`` when ``device_type`` is ``"cuda"`` and every rank of
    this host (``LOCAL_WORLD_SIZE``, else the world) has a card of its own,
    else ``gloo``. A CUDA rank's device is ``cuda:(LOCAL_RANK or rank) %
    cards``. A failed initialisation raises.
    """
    if dist.is_initialized():
        return
    store = None
    if init_method is None and all(k in os.environ for k in (
            "RANK", "WORLD_SIZE", "MASTER_ADDR")):
        init_method = "env://"
        world_size = int(os.environ["WORLD_SIZE"])
        rank = int(os.environ["RANK"])
    elif init_method is None:
        if world_size not in (None, 1) or rank not in (None, 0):
            raise ValueError("a world of more than one rank needs "
                             "init_method or torchrun's environment")
        store, world_size, rank = dist.HashStore(), 1, 0
    if world_size is None or rank is None:
        raise ValueError("init_method needs world_size and rank")
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    if device_type == "cuda":
        resolve_device("cuda")  # raises without a card
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    backend = _backend_for(device_type, local_world)
    if store is None:
        dist.init_process_group(backend, init_method=init_method,
                                world_size=world_size, rank=rank)
    else:
        dist.init_process_group(backend, store=store, world_size=1, rank=0)


def make_sdf_mesh(cells: Optional[int] = None, tris: int = 1,
                  ranks: Optional[Sequence[int]] = None, *,
                  device_type: str = "cuda") -> DeviceMesh:
    """A (cells, tris) ``DeviceMesh`` over ``ranks`` (default: the world),
    row-major: rank ``ranks[c·tris + t]`` sits at (c, t). Defaults: all
    ranks on the cell axis. Every rank of the world calls it (it makes the
    sub-groups); a rank outside ``ranks`` gets no coordinate."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call initialize_distributed")
    ranks = list(range(dist.get_world_size()) if ranks is None else ranks)
    n = len(ranks)
    if cells is None:
        cells = n // tris
    if cells * tris != n:
        raise ValueError(f"mesh {cells}x{tris} != {n} ranks")
    return DeviceMesh(device_type,
                      torch.tensor(ranks, dtype=torch.int64).reshape(cells,
                                                                     tris),
                      mesh_dim_names=(CELL_AXIS, TRI_AXIS))


def cell_sharding(mesh: DeviceMesh) -> tuple:
    """Placements of an array whose rows are split over ``cells``."""
    return (Shard(0), Replicate())


def tri_sharding(mesh: DeviceMesh) -> tuple:
    """Placements of an array whose rows are split over ``tris``."""
    return (Replicate(), Shard(0))


def replicated(mesh: DeviceMesh) -> tuple:
    """Placements of an array that every rank holds whole."""
    return (Replicate(), Replicate())


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return int(mesh.mesh.shape[mesh.mesh_dim_names.index(axis)])


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    """This rank's coordinate along ``axis``."""
    return mesh.get_local_rank(axis)


def local_rows(array, mesh: DeviceMesh, placements):
    """This rank's rows of ``array`` (numpy array or tensor) under
    ``placements``: for every mesh dimension with ``Shard(0)``, the
    coordinate's equal part of the rows (the row count must divide)."""
    rows = array
    for dim, placement in enumerate(placements):
        if isinstance(placement, Shard):
            if placement.dim != 0:
                raise ValueError("only row sharding (Shard(0))")
            n = int(mesh.mesh.shape[dim])
            if rows.shape[0] % n:
                raise ValueError(f"{rows.shape[0]} rows do not divide "
                                 f"{n} shards")
            per = rows.shape[0] // n
            c = mesh.get_local_rank(dim)
            rows = rows[c * per:(c + 1) * per]
    return rows


def pad_for_axis(n: int, mesh: DeviceMesh, axis: str,
                 multiple: int = 1) -> int:
    """Smallest padded size divisible by (axis size × multiple)."""
    div = axis_size(mesh, axis) * multiple
    return ((n + div - 1) // div) * div


# ------------------------------------------------------------ collectives
def _staged(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` where ``group``'s backend takes it; a host copy of a CUDA
    tensor for gloo."""
    if t.is_cuda and dist.get_backend(group) == "gloo":
        return t.cpu()
    return t.contiguous()


def _all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """(group size, *x.shape): every rank's ``x``, in group rank order."""
    n = dist.get_world_size(group)
    src = _staged(x, group).reshape(-1)
    out = torch.empty((n * src.numel(),), dtype=x.dtype, device=src.device)
    dist.all_gather_into_tensor(out, src, group=group)
    return out.view((n,) + tuple(x.shape)).to(x.device)


def _psum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of every rank's ``x`` (all_reduce SUM), a new tensor."""
    buf = _staged(x, group).clone()
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    return buf.to(x.device)


def _all_reduce_(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum ``t`` over ``group`` (default: the world) in place."""
    buf = _staged(t, group)
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    if buf.data_ptr() != t.data_ptr():
        t.copy_(buf)
    return t


class _GatherMin(torch.autograd.Function):
    """Min over the ranks of ``group`` of each rank's (Q,) ``x``: forward
    all_gather + min. Backward: the cotangent goes to this rank's input
    where its shard won, split equally among tied shards (``jnp.min``'s
    VJP). Every rank of the group holds the same cotangent (the result is
    replicated over the group), so no collective runs backward."""

    @staticmethod
    def forward(ctx, x, group):
        stacked = _all_gather(x, group)
        out = torch.amin(stacked, dim=0)
        won = x == out
        ctx.save_for_backward(won, torch.sum(stacked == out, dim=0))
        return out

    @staticmethod
    def backward(ctx, g):
        won, ties = ctx.saved_tensors
        return torch.where(won, g / ties.to(g.dtype), 0.0), None


def _gather_min(x: torch.Tensor, group) -> torch.Tensor:
    return _GatherMin.apply(x, group)


def _exchange(lo: torch.Tensor, hi: torch.Tensor, mesh: DeviceMesh):
    """Send ``lo`` to the left neighbour on ``cells`` and ``hi`` to the
    right one; receive the left neighbour's ``hi`` and the right one's
    ``lo``. Returns (from_left, from_right), None where this rank is at an
    end of the axis: nothing is sent past the ends."""
    group = mesh.get_group(CELL_AXIS)
    c = axis_index(mesh, CELL_AXIS)
    t = axis_index(mesh, TRI_AXIS)
    n = axis_size(mesh, CELL_AXIS)
    ops, recv = [], {}
    for side, peer_c, send in (("left", c - 1, lo), ("right", c + 1, hi)):
        if not 0 <= peer_c < n:
            continue
        peer = int(mesh.mesh[peer_c, t])
        buf = _staged(send, group)
        recv[side] = torch.empty_like(buf)
        ops.append(dist.P2POp(dist.isend, buf, peer, group))
        ops.append(dist.P2POp(dist.irecv, recv[side], peer, group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return tuple(recv[s].to(lo.device) if s in recv else None
                 for s in ("left", "right"))
