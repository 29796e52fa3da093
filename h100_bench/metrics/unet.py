"""The se cascade's U-Net marks in a traced window; no metric of its own.

The program launches layer marks inside its phases (``utils/profiling.py``
``LAYER_MARKS``, written here as strings): ``mark_unet_begin`` and
``mark_unet_end`` around the U-Net's forward, in training and validation
forwards alike, and ``mark_unet_backward_begin`` where the U-Net's
backward begins, after the head's and the losses'. :func:`per_step_ms`
gives, in ms a training step (``phases.STEP_MARK``):

* ``forward``: the device time between each U-Net begin mark and the next
  end mark that lie inside a training forward (between
  ``mark_forward_begin`` and ``mark_forward_end``);
* ``backward``: the device time from each ``mark_unet_backward_begin`` to
  the next ``mark_backward_end``.

Device time is ``phases._Busy``'s union of every operation but the
marks, phase and layer marks alike.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from h100_bench.metrics.phases import MARKS as PHASE_MARKS
from h100_bench.metrics.phases import STEP_MARK, _Busy, _pairs

MARKS = ('mark_unet_begin', 'mark_unet_end', 'mark_unet_backward_begin')


def _inside(inner, outer) -> List[Tuple[int, int]]:
    """The intervals of ``inner`` that lie inside one of ``outer`` (both
    sorted, ``outer`` disjoint)."""
    if not outer:
        return []
    lo, hi = np.asarray(outer, np.int64).T
    out = []
    for a, b in inner:
        i = int(np.searchsorted(lo, a, side='right')) - 1
        if i >= 0 and b <= hi[i]:
            out.append((a, b))
    return out


def _read(trace) -> Dict[str, float]:
    lo, hi = trace.window
    if not trace.ops:
        return {}
    names, starts, ends = zip(*trace.ops)
    starts = np.fromiter(starts, np.int64, len(starts))
    ends = np.fromiter(ends, np.int64, len(ends))
    marked = set(PHASE_MARKS) | set(MARKS)
    is_mark = np.fromiter((n in marked for n in names), bool, len(names))
    marks: Dict[str, List[Tuple[int, int]]] = {m: [] for m in marked}
    for i in np.flatnonzero(is_mark & (starts >= lo) & (ends <= hi)):
        marks[names[i]].append((int(starts[i]), int(ends[i])))
    steps = len(marks[STEP_MARK])
    if steps == 0:
        return {}
    busy = _Busy(starts[~is_mark], ends[~is_mark], lo, hi)

    def pairs(begin, end):
        return _pairs([e for _, e in marks[begin]],
                      [s for s, _ in marks[end]])
    out = {}
    unet = pairs('mark_unet_begin', 'mark_unet_end')
    if unet:
        training = pairs('mark_forward_begin', 'mark_forward_end')
        out['forward'] = busy.within(_inside(unet, training)) / steps / 1e6
    backward = pairs('mark_unet_backward_begin', 'mark_backward_end')
    if backward:
        out['backward'] = busy.within(backward) / steps / 1e6
    return out


def per_step_ms(ctx, part: str) -> Optional[float]:
    """The U-Net's ``part`` (``forward`` or ``backward``) in ms a training
    step in the traced window of a fit cell's ``ctx``; None where the
    trace has no U-Net marks. The window is read once a run and kept in
    ``ctx``."""
    if ctx.get('kind') != 'fit' or ctx.get('trace') is None:
        return None
    if 'unet_ms' not in ctx:
        ctx['unet_ms'] = _read(ctx['trace'])
    return ctx['unet_ms'].get(part)
