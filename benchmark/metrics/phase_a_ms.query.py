"""Device time per traced call of CULLED's phase A (``ops.kernels.culled``
``_phase_a_topk``, the gather engine's, and ``select_blocks``, the union
engine's), ms."""
from benchmark.harness import readers

SPANS = [("mesh_to_sdf_tpu_torch.ops.kernels.culled", "_phase_a_topk",
          "phase_a"),
         ("mesh_to_sdf_tpu_torch.ops.kernels.culled", "select_blocks",
          "phase_a")]


def read(ctx):
    return readers.device_ms(ctx, "phase_a")
