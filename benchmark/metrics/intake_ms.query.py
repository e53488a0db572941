"""Host time per traced call of the query call's intake (the port's
``query.soup`` span: the vertices to the host, the triangle gather, pad
and upload; and ``query.structures``: the content keys and cache lookups
of CULLED's per-mesh structures), ms."""
from benchmark.harness import readers


def read(ctx):
    soup = readers.host_ms(ctx, "query.soup")
    if soup is None:
        return None
    return soup + (readers.host_ms(ctx, "query.structures") or 0.0)
