"""Device time per traced call of the kernels launched by the CPT seed
(``ops.cpt.seed_from_bins``), ms."""
from benchmark.harness import readers

SPANS = [("mesh_to_sdf_tpu_torch.ops.cpt", "seed_from_bins", "seed")]


def read(ctx):
    return readers.device_ms(ctx, "seed")
