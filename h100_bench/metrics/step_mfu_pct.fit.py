"""step_mfu_pct.fit: the whole training step's share of the chip's peak.

The model FLOPs of the window's steps (a training step 3 times the
configuration's forward, a validation step once; ``work.forward_flops``,
from shapes) over the window's wall seconds, as a share of the compute
dtype's published peak (``work.PEAK_FLOPS``). Read in fit cells only."""


def read(ctx):
    if ctx.get('kind') != 'fit' or not ctx.get('window_s'):
        return None
    flops = ctx['fwd_flops'] * (3 * ctx['train_steps'] + ctx['val_steps'])
    return 100.0 * flops / ctx['window_s'] / ctx['peak_flops']
