"""Host time of the CPT route's prep per traced call (``gridgen._cpt_prep``:
the content-keyed cache lookup and, on a miss, subdivision, native seed
bins, the three line-bin tables and their upload), ms."""
from benchmark.harness import readers

SPANS = [("mesh_to_sdf_tpu_torch.gridgen", "_cpt_prep", "host_prep")]


def read(ctx):
    return readers.host_ms(ctx, "host_prep")
