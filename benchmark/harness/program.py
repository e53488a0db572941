"""What the readers of the port's own spans share. The port opens them
itself (``mesh_to_sdf_tpu_torch.utils.profiling.span``) while a profiler
runs: ``<path>.entry`` around each call, spans inside it, and one
``sync.<path>.<site>`` span around each place the call makes the host wait
on the card. A program that opens none (an older commit) gives None."""
from __future__ import annotations

#: Prefix of the port's host-sync spans.
SYNC = "sync."


def syncs_per_call(ctx, path: str):
    """Host syncs per traced call: occurrences of ``sync.*`` spans over
    the traced calls, where the port opened ``<path>.entry``."""
    s = ctx.summary
    if s is None or s.span_count(f"{path}.entry") == 0:
        return None
    n = sum(count for name, (count, _, _) in s.spans.items()
            if name.startswith(SYNC))
    return n / s.calls


def idle_ms(ctx, span: str):
    """Device-idle time per traced call whose innermost open span is
    ``span`` (with or without a host op named under it), ms."""
    s = ctx.summary
    if s is None or s.span_count(span) == 0:
        return None
    idle = sum(v for k, v in s.idle_gaps.items()
               if k == span or k.startswith(span + " / "))
    return 1e3 * idle / s.calls
