"""unet_backward_ms.fit_se: the device time of the se cascade's U-Net
backward, in ms a training step: from the program's layer mark
``mark_unet_backward_begin`` to the phase mark ``mark_backward_end``
(``unet.py``). The rest of the backward phase, before that mark, is the
head's and the losses' backward. Nothing where the trace has no such
mark."""

from h100_bench.metrics.unet import per_step_ms


def read(ctx):
    return per_step_ms(ctx, 'backward')
