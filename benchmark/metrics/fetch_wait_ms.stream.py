"""Host time per traced call spent waiting on the slab stream's fetch (the
port's ``sync.stream.fetch.*`` spans: a staging buffer's previous slab,
the last slabs' drains and the final synchronize): the part of the field's
copy to host memory that its overlap with the compute did not hide, ms."""

PREFIX = "sync.stream.fetch."


def read(ctx):
    s = ctx.summary
    if s is None:
        return None
    names = [n for n in s.spans if n.startswith(PREFIX)]
    if not names:
        return None
    return 1e3 * sum(s.span_host_s(n) for n in names) / s.calls
