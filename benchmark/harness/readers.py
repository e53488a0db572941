"""What the metric readers (``metrics/<name>.py``) share: each reader is
one of these on its own span, or one of them as it stands. Each returns
None where its run holds nothing to read."""
from __future__ import annotations

from benchmark.harness import window


def rate(ctx):
    """All the work of the window over all its time (host clock)."""
    return window.rate(ctx.window)


def idle_pct(ctx):
    """Share of the traced window in which no kernel, copy or fill ran on
    the card, %."""
    s = ctx.summary
    if s is None or s.busy_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)


def device_ms(ctx, span: str):
    """Device time per traced call of the work launched inside ``span``,
    ms."""
    s = ctx.summary
    if s is None or s.span_device_s(span) <= 0:
        return None
    return 1e3 * s.span_device_s(span) / s.calls


def host_ms(ctx, span: str):
    """Host time per traced call inside ``span``, ms."""
    s = ctx.summary
    if s is None or s.span_count(span) == 0:
        return None
    return 1e3 * s.span_host_s(span) / s.calls
