"""synth_roofline_pct.fit: the synthesis kernels' share of their roofline.

The least time a launch takes on average (``work.synth_bound_s`` over the
draws of every training and validation batch of the traced window, worked
out again from the seeds: each launch's bytes at HBM bandwidth, or its
operations at the float32 peak, whichever is longer) over the mean device
time of a launch of the program's ``synth_*`` kernels in the trace.
Nothing when the trace holds no such kernel."""


def read(ctx):
    trace = ctx.get('trace')
    if trace is None or ctx.get('synth_bound_s') is None:
        return None
    times = trace.op_seconds('synth_')
    if not times:
        return None
    return 100.0 * ctx['synth_bound_s'] / (sum(times) / len(times))
