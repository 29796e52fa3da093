"""The se cells' frozen work counts; no metric of its own.

* :func:`forward_flops`: the se cascade's forward FLOPs at the
  configuration's batch, on its input [B, 256, n_frame, n_chan] (the
  preprocessed spectrogram, not a mel), counted by
  ``work.forward_flops``.
* :func:`se_work`: the bytes and operations that the se triple of one
  batch's draws needs, each byte once: the background windows, the rows
  of every active clip that land in the window and the slot tables read
  once, the three complex windows (the full mix, only_voice, only_noise)
  written; a multiply and an add per clip element and an add into its
  sub-mix. These are ``chip_smoke.py``'s ``synth_work(d, width,
  torch.float32, flat=True, outputs=3)``: the work of the program's se
  triple kernel, whatever implements it.
"""

from __future__ import annotations

import torch

from h100_bench.metrics import work

ROWS = 256                  # the se input's frequency rows, DC dropped
WINDOWS = 3                 # the se triple's outputs


def forward_flops(build, config: dict) -> int:
    """FLOPs of one inference-mode forward of ``build(config)`` at the
    configuration's batch and the se input shape (``work.forward_flops``
    with the input's rows in place of its mel bins)."""
    model = dict(config['model'], n_mels=ROWS)
    return work.forward_flops(build, dict(config, model=model))


def se_work(d, width: int, elem: int = 4):
    """(bytes, flops) of the se triple of the draws ``d`` (with
    ``n_frame``, ``bidx``, ``vshift``, ``vw``, ``vlens``, ``nshift``,
    ``nw``, ``nlens``) from float32 banks of ``width`` columns."""
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
    out = WINDOWS * window
    return elem * (window + rows * width + out) + table, 3 * rows * width

