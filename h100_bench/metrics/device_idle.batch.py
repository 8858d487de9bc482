"""``device_idle.batch``: ``metrics.common.device_idle``."""

from h100_bench.metrics.common import device_idle as read  # noqa: F401
