"""Device time per traced call of the grid's sign: binned line parity on
three axes and the vote (``ops.kernels.parity.grid_inside_mask``), ms."""
from benchmark.harness import readers

SPANS = [("mesh_to_sdf_tpu_torch.ops.kernels.parity", "grid_inside_mask",
          "sign")]


def read(ctx):
    return readers.device_ms(ctx, "sign")
