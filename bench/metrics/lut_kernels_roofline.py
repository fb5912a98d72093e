"""lut_kernels_roofline: the forward's least time (its bytes over the
card's memory bandwidth, ``harness/roofline.py``) as a percentage of
the device time its kernels take (``lut_kernels_us``)."""


def read(ctx):
    t = getattr(ctx, "trace", None)
    least = getattr(ctx, "least_s", None)
    if t is None or least is None or t.forward_busy_s <= 0:
        return None
    return 100.0 * least * t.forwards / t.forward_busy_s
