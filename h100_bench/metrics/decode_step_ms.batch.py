"""``decode_step_ms.batch``: milliseconds of device time a MusicGen decoder
forward: the device time of the operations launched inside the traced
calls' decoder forwards over the forwards they ran."""


def read(ctx):
    t = ctx.trace
    forwards = sum(c["work"].get("decode_forwards", 0) for c in ctx.traced_calls)
    if not t or not t["unet_device_s"] or not forwards:
        return None
    return 1e3 * t["unet_device_s"] / forwards
