"""Device-idle time per traced call while the innermost open span is the
port's ``query.culled.phase_a`` (CULLED's phase A, both passes: the
eager launches of ``_phase_a_topk`` or ``select_blocks``), ms."""
from benchmark.harness import program


def read(ctx):
    return program.idle_ms(ctx, "query.culled.phase_a")
