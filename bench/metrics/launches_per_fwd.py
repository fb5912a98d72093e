"""launches_per_fwd: device kernels a forward launches, from the
profiler's trace of the traced stretch; the harness's own copies are
not counted."""


def read(ctx):
    t = getattr(ctx, "trace", None)
    return None if t is None else t.forward_kernels / t.forwards
