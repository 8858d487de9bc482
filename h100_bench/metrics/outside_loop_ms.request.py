"""``outside_loop_ms.request``: ``metrics.common.outside_loop_ms``."""

from h100_bench.metrics.common import outside_loop_ms as read  # noqa: F401
