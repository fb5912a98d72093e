"""lut_kernels_us: device microseconds a forward, the union of the
device intervals of every kernel the forwards launched over the traced
stretch, per forward.  Not keyed to a kernel's name: a renamed or split
kernel is still counted.  Read only from a trace that holds every
launch."""


def read(ctx):
    t = getattr(ctx, "trace", None)
    return None if t is None else 1e6 * t.forward_busy_s / t.forwards
