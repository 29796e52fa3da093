"""unet_forward_ms.fit_se: the device time of the se cascade's U-Net in a
training step's forward, in ms a training step: between the program's
layer marks ``mark_unet_begin`` and ``mark_unet_end`` inside the training
forwards (``unet.py``). Nothing where the trace has no such marks."""

from h100_bench.metrics.unet import per_step_ms


def read(ctx):
    return per_step_ms(ctx, 'forward')
