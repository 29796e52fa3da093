"""The yardstick's frozen work counts and peaks; no metric of its own.

* ``PEAK_FLOPS``: one NVIDIA H100 SXM's dense rates by compute dtype
  (NVIDIA H100 Tensor Core GPU data sheet, at the 700 W limit): float32
  outside the tensor cores 67 TFLOP/s (the port runs float32 with TF32
  off), bfloat16 989 TFLOP/s. ``HBM_BYTES_PER_S``: 3.35 TB/s.
* :func:`forward_flops`: a model's forward FLOPs at its batch, counted from
  shapes by ``torch.utils.flop_counter.FlopCounterMode`` on the reference
  model on the meta device (convolutions and matrix products; elementwise
  work is not counted). A training step counts 3 times its forward and a
  validation step once: the counter's own backward is not used, since it
  counts a grouped (depthwise) convolution's backward some 50 times too
  high.
* :func:`synth_work`: the bytes and operations that synthesizing one
  batch's draws needs, each byte once (the background windows, the rows of
  every active clip that land in the window, the slot tables, the
  magnitude written), a multiply and an add per clip element and 3
  operations and a root per magnitude: the work of the program's synthesis
  kernel, whatever implements it.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

PEAK_FLOPS = {'float32': 67e12, 'bfloat16': 989e12}
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = PEAK_FLOPS['float32']


def forward_flops(build, config: dict) -> int:
    """FLOPs of one inference-mode forward of ``build(config)`` at the
    configuration's batch and input shape."""
    m = config['model']
    with torch.device('meta'):
        module = build(config).eval()
        x = torch.empty(m['batch_size'], m['n_mels'], m['n_frame'],
                        m['n_chan'])
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        module(x)
    return int(counter.get_total_flops())


def synth_work(d, width: int, elem: int = 4, out_elem: int = 4):
    """(bytes, flops) of the magnitude synthesis of the draws ``d`` (with
    ``n_frame``, ``bidx``, ``vshift``, ``vw``, ``vlens`` and, where there are
    noises, ``nshift``, ``nw``, ``nlens``) from banks of ``width`` columns
    of ``elem`` bytes, the magnitude written in ``out_elem`` bytes."""
    n_frame, b = d.n_frame, d.bidx.shape[0]
    rows, table = 0, 2 * b * 4
    for shift, w, lens in ((d.vshift, d.vw, d.vlens),
                           (d.nshift, d.nw, d.nlens)):
        if shift is None:
            continue
        lo = (-shift).clamp(min=0)
        hi = torch.minimum(lens, n_frame - shift)
        rows += int(((hi - lo).clamp(min=0) * (w != 0)).sum())
        table += 4 * shift.numel() * 4
    window = b * n_frame * width
    out = b * n_frame * (width // 2)
    return (elem * (window + rows * width) + out_elem * out + table,
            2 * rows * width + 4 * out)


def synth_bound_s(works) -> float:
    """The least time a launch takes on average over ``works`` ((bytes,
    flops) of each launch's draws): each launch's bytes at HBM bandwidth or
    operations at the float32 peak, whichever is longer."""
    return sum(max(b / HBM_BYTES_PER_S, f / FP32_FLOPS)
               for b, f in works) / len(works)
