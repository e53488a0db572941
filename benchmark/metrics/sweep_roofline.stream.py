"""The slab stream's sweeps' share of their roofline: the frozen bound of
the call's directional sweeps over the device time per traced call under
the port's ``stream.sweep`` spans, %.

A call runs two passes over nx / slab x-slabs of ``slab`` cells, the
widest divisor of nx up to ``SLAB_NX`` (the route's rule), each slab pass
eight sweeps (one round of six, then the ±x pair), each bounded as one
sixth of ``roofline_frozen.sweep_bound_s`` of a slab and the mesh's
triangles."""
from benchmark import roofline_frozen
from benchmark.harness import readers

#: The stream's default slab width, and sweeps per slab pass.
SLAB_NX = 64
SWEEPS_PER_PASS = 8


def read(ctx):
    ms = readers.device_ms(ctx, "stream.sweep")
    if ms is None:
        return None
    nx, ny, nz = (int(c) for c in ctx.cell.config["args"]["grid"]["cells"])
    slab = max(w for w in range(1, min(SLAB_NX, nx) + 1) if nx % w == 0)
    sweeps = 2 * (nx // slab) * SWEEPS_PER_PASS
    per_sweep = roofline_frozen.sweep_bound_s(
        slab * ny * nz, ctx.n_triangles) / roofline_frozen.SWEEPS
    return 100.0 * 1e3 * sweeps * per_sweep / ms
