"""Host syncs per traced call of the CULLED query route: the port's
``sync.*`` spans (one around each copy between host and card memory, or
host read of a card tensor) inside ``query.entry``, over the traced
calls."""
from benchmark.harness import program


def read(ctx):
    return program.syncs_per_call(ctx, "query")
