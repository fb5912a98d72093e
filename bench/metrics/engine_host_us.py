"""engine_host_us: the host's microseconds in one call into the serving
callable (``make_network_fn``'s ``run`` and the ``lut_gather.py`` launch
wrapper), by the harness's own clock around each call, averaged over the
untraced stretch of the window (the profiler would add its own cost to
every call of the traced one)."""


def read(ctx):
    w = getattr(ctx, "window", None)
    calls = w.host_call_s if w is not None else None
    return 1e6 * sum(calls) / len(calls) if calls else None
