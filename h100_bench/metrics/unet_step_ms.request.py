"""``unet_step_ms.request``: ``metrics.common.unet_step_ms``."""

from h100_bench.metrics.common import unet_step_ms as read  # noqa: F401
