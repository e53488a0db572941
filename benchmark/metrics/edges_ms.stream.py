"""Device time per traced call of the slab stream's edge work (the port's
``stream.edges`` spans: per slab pass the runner-up reset, the two edge
merges and the copies of the slab's first and last rows), ms."""
from benchmark.harness import readers


def read(ctx):
    return readers.device_ms(ctx, "stream.edges")
