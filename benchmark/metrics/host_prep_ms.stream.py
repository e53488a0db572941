"""Host time per traced call of the slab stream's prep (the port's
``stream.prep`` span: the content key of the mesh and grid and the cache
lookup; on a miss the subdivision, the per-slab line and seed bins and
their upload), ms."""
from benchmark.harness import readers


def read(ctx):
    return readers.host_ms(ctx, "stream.prep")
