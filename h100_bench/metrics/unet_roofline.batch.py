"""``unet_roofline.batch``: ``metrics.common.unet_roofline``."""

from h100_bench.metrics.common import unet_roofline as read  # noqa: F401
