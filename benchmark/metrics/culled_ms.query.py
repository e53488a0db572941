"""Device time per traced call of the culled kernel (``ops.kernels.culled``
``culled_blocks``, every round: main, widen and the fallback's re-run),
ms."""
from benchmark.harness import readers

SPANS = [("mesh_to_sdf_tpu_torch.ops.kernels.culled", "culled_blocks",
          "culled")]


def read(ctx):
    return readers.device_ms(ctx, "culled")
