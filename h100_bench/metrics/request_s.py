"""``request_s``: ``metrics.common.seconds_per_call``."""

from h100_bench.metrics.common import seconds_per_call as read  # noqa: F401
