"""Offline visualization: samplers, raymarch renderer, isosurface tools.

PyTorch counterpart of the JAX package's ``render`` (the reference client's
GPU render passes, SURVEY.md §2.2 K6-K10, as array programs): the raymarch
fragment shader becomes a vectorised sphere-trace over the pixel grid, the
voxel pass a DDA over the iso band, the model pass a per-pixel ray cast of
the soup, and PNG files (written without an imaging package) replace the
swapchain. Everything runs as torch operations on the device of its inputs
(default CUDA).
"""
from .sampler import RaymarchMode, sample, sample_snap, sample_trilinear, sample_tetrahedral
from .raymarch import Camera, render, trace, estimate_normal
from .isosurface import ordered_indices, iso_limits, voxel_band, surface_cells, point_cloud
from .image import save_png, to_uint8
from .splat import colorize_distances, render_points, render_sdf_points
from .cubemap import Cubemap, generate_cubemap, sample_cubemap
from .model import render_model, render_model_and_sdf, trace_mesh
from .voxels import band_occupancy, dda_trace, render_voxels

__all__ = [
    "render_model", "render_model_and_sdf", "trace_mesh",
    "RaymarchMode", "sample", "sample_snap", "sample_trilinear",
    "sample_tetrahedral", "Camera", "render", "trace", "estimate_normal",
    "ordered_indices", "iso_limits", "voxel_band", "surface_cells",
    "point_cloud", "save_png", "to_uint8",
    "colorize_distances", "render_points", "render_sdf_points",
    "Cubemap", "generate_cubemap", "sample_cubemap",
    "band_occupancy", "dda_trace", "render_voxels",
]
