"""Device time per traced call of the fused raycast kernel under CULLED (the
fix-up of flagged queries and the host fallback's batch, both
``ops.kernels.sdf.sdf_raycast``), ms."""
from benchmark.harness import readers

SPANS = [("mesh_to_sdf_tpu_torch.ops.kernels.sdf", "sdf_raycast", "fixup")]


def read(ctx):
    return readers.device_ms(ctx, "fixup")
