"""DifferentiableSDF — mesh vertices as trainable parameters (PyTorch
counterpart of ``models/sdf_layer.py``).

An SDF grid as a differentiable layer (BASELINE.json north star "SDF grids
become a trainable layer"). The training demo fits a template mesh's
vertices so its SDF grid matches a target grid: the forward pass is
``generate_grid_sdf`` restated through the autograd Functions of
``ops.autodiff``, the backward flows d(loss)/d(vertices) through the
closest-point projection, and ``torch.optim.Adam`` (optax's ``adam``
defaults: betas (0.9, 0.999), eps 1e-8) takes the step.

Tensors stay on the device of the vertices: CUDA vertices run the sweep
kernel (``engine="cpt"``) and the dense parity kernel (the raycast sign of
:func:`sdf_grid`), CPU vertices their plain versions.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..grid import Grid
from ..ops import autodiff, culling, raycast
from ..ops.keyed import combine_champions
from ..query import resolve_device
from ..types import SignMethod


def pad_tri_idx(tri_idx: np.ndarray, block: int) -> np.ndarray:
    """Pad (M,3) int triangle indices to a multiple of ``block`` with -1
    sentinel rows (masked inside the kernels)."""
    m = tri_idx.shape[0]
    pad = (-m) % block if m > 0 else block
    if pad:
        tri_idx = np.concatenate(
            [tri_idx, np.full((pad, 3), -1, tri_idx.dtype)], axis=0
        )
    return tri_idx.astype(np.int32)


def _sign_soup(vertices, tri_idx):
    """Detached (ta, tb, tc, valid) for the sign, which is piecewise
    constant and carries no gradient."""
    ids = torch.clamp_min(tri_idx, 0).long()
    v = vertices.detach()
    return v[ids[:, 0]], v[ids[:, 1]], v[ids[:, 2]], tri_idx[:, 0] >= 0


def sdf_at_points(vertices, tri_idx, queries,
                  sign_method: SignMethod = SignMethod.NORMAL, *,
                  raycast_axes: int = 3, block: int = 512) -> torch.Tensor:
    """Differentiable signed distance at query points, (Q,).

    The sign (parity vote or normal side) is piecewise constant and carries
    no gradient; magnitudes flow through the autograd Functions.
    """
    if sign_method == SignMethod.NORMAL:
        mp, mn = autodiff.signed_champion_distances(vertices, tri_idx,
                                                    queries, block)
        return combine_champions(mp, mn)
    dist = autodiff.unsigned_min_distance(vertices, tri_idx, queries, block)
    counts = culling._ray_parity_counts(queries.detach(),
                                        *_sign_soup(vertices, tri_idx),
                                        raycast_axes)
    odd = counts % 2 == 1
    if raycast_axes == 1:
        inside = odd[:, 0]
    else:
        inside = torch.sum(odd, dim=1) >= 2
    return torch.where(inside, -dist, dist)


def sdf_grid(vertices, tri_idx, grid: Grid,
             sign_method: SignMethod = SignMethod.RAYCAST, *,
             block: int = 512) -> torch.Tensor:
    """Differentiable grid SDF, shape (nx, ny, nz)."""
    centers = grid.all_cell_centers(vertices.device).reshape(-1, 3)
    if sign_method == SignMethod.RAYCAST:
        dist = autodiff.unsigned_min_distance(vertices, tri_idx, centers,
                                              block)
        dist = dist.reshape(grid.cell_count)
        inside = raycast.grid_inside_mask(grid,
                                          *_sign_soup(vertices, tri_idx))
        return torch.where(inside, -dist, dist)
    mp, mn = autodiff.signed_champion_distances(vertices, tri_idx, centers,
                                                block)
    return combine_champions(mp, mn).reshape(grid.cell_count)


@dataclass
class SdfFitState:
    """The fit's parameters (the (V, 3) vertices, a leaf that requires
    grad) and the Adam optimizer that holds their moments and step count.
    ``models.checkpoint`` carries it to and from optax's layout."""

    params: torch.Tensor
    opt_state: torch.optim.Adam


class DifferentiableSDF:
    """Fit mesh vertices to a target SDF grid by gradient descent.

    ``engine="dense"`` uses the exact O(cells·tris) reductions;
    ``engine="cpt"`` builds the O(cells+tris) CPT forward with the envelope
    backward (``ops.autodiff.make_cpt_grid_distance``), the scalable choice
    for big grids and meshes. Both flow d(loss)/d(vertices) through the
    closest-point projection."""

    def __init__(self, tri_idx, grid: Grid, sign_method=SignMethod.NORMAL,
                 learning_rate: float = 1e-2, block: int = 512,
                 engine: str = "dense", vertices_example=None):
        self.tri_idx = torch.from_numpy(pad_tri_idx(np.asarray(tri_idx),
                                                    block))
        self.grid = grid
        self.sign_method = sign_method
        self.block = block
        self.engine = engine
        self.learning_rate = learning_rate
        self._cpt_fn = None
        if engine == "cpt":
            if vertices_example is None:
                raise ValueError("engine='cpt' needs vertices_example "
                                 "(subdivision structure is fixed at build)")
            self._cpt_fn = autodiff.make_cpt_grid_distance(
                grid, np.asarray(tri_idx), vertices_example)

    def optimizer(self, params: torch.Tensor) -> torch.optim.Adam:
        """A fresh Adam over ``params`` with optax's ``adam`` defaults."""
        return torch.optim.Adam([params], lr=self.learning_rate,
                                betas=(0.9, 0.999), eps=1e-8)

    def init(self, vertices, device=None) -> SdfFitState:
        """The initial state: ``vertices`` as float32 parameters on
        ``device`` (default: the device of a tensor ``vertices``, else
        CUDA), and an optimizer with no moments yet."""
        v = torch.as_tensor(vertices).detach().to(
            resolve_device(device, vertices), torch.float32)
        v = v.clone().requires_grad_(True)
        return SdfFitState(params=v, opt_state=self.optimizer(v))

    def loss(self, vertices, target_grid_sdf):
        if not isinstance(target_grid_sdf, torch.Tensor):
            target_grid_sdf = np.array(target_grid_sdf, np.float32)
        target = torch.as_tensor(target_grid_sdf, dtype=torch.float32,
                                 device=vertices.device)
        if self.engine == "cpt":
            # Unsigned-distance fit (sign is piecewise constant anyway and
            # the usual fitting target is the |SDF| field near the surface).
            pred = self._cpt_fn(vertices)
            return torch.mean((pred - torch.abs(target)) ** 2)
        pred = sdf_grid(vertices, self.tri_idx.to(vertices.device), self.grid,
                        self.sign_method, block=self.block)
        return torch.mean((pred - target) ** 2)

    def train_step(self, state: SdfFitState, target_grid_sdf,
                   ) -> tuple[SdfFitState, torch.Tensor]:
        """One Adam step. Returns ``(state, loss)``: the state is updated in
        place, the loss is that of the parameters before the step."""
        opt = state.opt_state
        opt.zero_grad(set_to_none=True)
        loss = self.loss(state.params, target_grid_sdf)
        loss.backward()
        opt.step()
        return state, loss.detach()
