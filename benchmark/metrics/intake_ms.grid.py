"""Host time per traced call of the grid call's intake (the port's
``grid.soup`` span: the vertices to the host and the triangle gather),
ms."""
from benchmark.harness import readers


def read(ctx):
    return readers.host_ms(ctx, "grid.soup")
