"""lut_fwd_mfu: the whole forward's share of the card's peak, as a
percentage: the least time of all forwards completed in the untraced
stretch of the window (bytes over memory bandwidth,
``harness/roofline.py``) over the wall time they took."""


def read(ctx):
    w = getattr(ctx, "window", None)
    least = getattr(ctx, "least_s", None)
    if w is None or least is None or w.issued == 0:
        return None
    return 100.0 * least * w.issued / w.span_s
