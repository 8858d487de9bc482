"""``mfu.batch``: ``metrics.common.mfu``."""

from h100_bench.metrics.common import mfu as read  # noqa: F401
