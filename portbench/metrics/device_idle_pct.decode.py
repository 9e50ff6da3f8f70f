"""device_idle_pct.decode: the share of the traced slice's wall time in which
no kernel, copy or set ran on the device, in %, from the profiler's
device records (`trace.read`). Nothing where the profiler saw no device
activity."""


def read(ctx):
    tr = ctx["trace"]
    if tr["busy_s"] <= 0 or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
