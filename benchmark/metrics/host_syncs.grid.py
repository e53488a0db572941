"""Host syncs per traced call of the CPT grid route: the port's ``sync.*``
spans (one around each copy between host and card memory, or host read of
a card tensor) inside ``grid.entry``, over the traced calls."""
from benchmark.harness import program


def read(ctx):
    return program.syncs_per_call(ctx, "grid")
