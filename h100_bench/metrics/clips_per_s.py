"""``clips_per_s``: ``metrics.common.clips_per_second``."""

from h100_bench.metrics.common import clips_per_second as read  # noqa: F401
