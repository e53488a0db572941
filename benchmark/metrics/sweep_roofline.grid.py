"""The CPT sweeps' share of their roofline: the frozen bound of one round
of six directional sweeps on the configuration's grid and mesh
(``roofline_frozen.sweep_bound_s``), over the device time per traced call
of the kernels ``ops.cpt.closest_point_grid`` launched, %."""
import numpy as np

from benchmark import roofline_frozen
from benchmark.harness import readers

SPANS = [("mesh_to_sdf_tpu_torch.ops.cpt", "closest_point_grid", "sweep")]


def read(ctx):
    ms = readers.device_ms(ctx, "sweep")
    if ms is None:
        return None
    cells = int(np.prod(ctx.cell.config["args"]["grid"]["cells"]))
    bound = roofline_frozen.sweep_bound_s(cells, ctx.n_triangles)
    return 100.0 * 1e3 * bound / ms
