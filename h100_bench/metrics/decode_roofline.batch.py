"""``decode_roofline.batch``: percent, the least time of the traced calls'
decoder steps on the card (``flops_musicgen.decode_bound_s``: each step's
weights, cache prefix and cross K/V at the HBM rate, or its operations at
the bf16 peak) over the device time of the operations launched inside
their decoder forwards."""


def read(ctx):
    t = ctx.trace
    if not t or not t["unet_device_s"] or not ctx.traced_calls:
        return None
    if any("decode_bound_s" not in c["work"] for c in ctx.traced_calls):
        return None
    return 100.0 * sum(c["work"]["decode_bound_s"] for c in ctx.traced_calls) / t["unet_device_s"]
