"""Share of the traced window in which no kernel, copy or fill ran on the
card, %."""
from benchmark.harness.readers import idle_pct as read  # noqa: F401
