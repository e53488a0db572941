"""Query points of every call in the window over the window's time."""
from benchmark.harness.readers import rate as read  # noqa: F401
