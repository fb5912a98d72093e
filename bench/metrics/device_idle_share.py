"""device_idle_share: the percentage of the traced stretch's wall time
in which nothing ran on the device: 1 - (the union of every device
activity, kernels, copies and memsets, the forward's and the harness's)
over the stretch's wall time, both from the profiler's trace.  The
profiler's own cost on the host lengthens the stretch where the host
sets the pace; the batches driver logs beside it the idle share its
device time a batch gives at the untraced stretch's rate."""


def read(ctx):
    t = getattr(ctx, "trace", None)
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
