"""device_idle_pct.fit: the share of a fit cell's traced window in which no
operation ran on the device (1 - the union of operation intervals over the
window)."""


def read(ctx):
    trace = ctx.get('trace')
    if ctx.get('kind') != 'fit' or trace is None or trace.window_s <= 0:
        return None
    busy = trace.busy_s()
    return 100.0 * (1.0 - busy / trace.window_s) if busy > 0 else None
