"""Tracing and step timing (counterpart: ``challenge_tpu/utils/profiling.py``).

Usage:
    with trace('tb'):                   # TensorBoard's profile plugin reads it
        metrics = train_step(state, batch)

    timer = StepTimer()
    for batch in batches:
        with timer:
            metrics = timer.sync(train_step(state, batch))
    print(timer.summary())

CUDA runs asynchronously, so a step's time is only its host dispatch unless
the timer waits for the card: ``timer.sync(...)`` registers the step's
tensors, and leaving the block synchronizes their CUDA devices.

The program carries two instruments of its own:

* host spans (:func:`span`): ``record_function`` ranges around the training
  loop's calls (``fit.train_step``, ``fit.eval_step``, ``fit.capture``,
  ``fit.readback``, ``fit.callbacks``, ``pipeline.build``). They are stamped
  on the profiler's clock, the one of its device records, so a trace shows
  which call the host was in when the device went idle. They are
  recorded only inside a profiled block; with no profiler running a span
  is one shared null context and costs one check;
* phase marks (:func:`mark`): an empty kernel of ``csrc/marks.cu`` for each
  name of :data:`MARKS`, launched on the current stream where a phase of a
  step begins and ends (the batch's features, the forward and loss, the
  backward, the update, the validation forward). A CUDA graph captures
  them with the step, so every replay runs them, traced or not; a replay is
  one launch on the host, and the marks split its device time by phase. On
  the CPU a mark does nothing. Marks are not counted in
  ``ops.cuda.LAUNCHES``;
* layer marks (:data:`LAYER_MARKS`, launched by :func:`mark` too): where a
  model's layer runs inside a phase. The se cascade
  (``models/senet.py``) marks its U-Net's forward (``mark_unet_begin``,
  ``mark_unet_end``) and where the U-Net's backward begins
  (``mark_unet_backward_begin``, launched from the backward of an
  identity on the U-Net's outputs): between it and
  ``mark_backward_end`` lies the U-Net's backward, before it the head's
  and the losses'.
"""

from __future__ import annotations

import contextlib
import ctypes
import time
from typing import List, Optional

import numpy as np
import torch

from challenge_tpu_torch.ops import cuda

# the phase marks, begin and end of each phase, in csrc/marks.cu's order
MARKS = ('mark_input_begin', 'mark_input_end',
         'mark_val_input_begin', 'mark_val_input_end',
         'mark_forward_begin', 'mark_forward_end',
         'mark_backward_begin', 'mark_backward_end',
         'mark_update_begin', 'mark_update_end',
         'mark_val_forward_begin', 'mark_val_forward_end')
# the layer marks, in csrc/marks.cu's order after MARKS
LAYER_MARKS = ('mark_unet_begin', 'mark_unet_end', 'mark_unet_backward_begin')
_MARK_IDS = {name: i for i, name in enumerate(MARKS + LAYER_MARKS)}
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A host span ``name`` over a ``with`` block: ``record_function(name)``
    while a profiler runs, else one shared null context, with no call into
    the profiler."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


def mark(name: str, device: torch.device) -> None:
    """Launch the mark ``name`` (one of :data:`MARKS` or
    :data:`LAYER_MARKS`) on the current stream of CUDA ``device``, the
    capturing stream while a graph captures; nothing on another device,
    nor while ``torch.compile`` or ``torch.export`` traces the caller (a
    traced program holds no marks)."""
    i = _MARK_IDS[name]
    if device.type != 'cuda' or torch.compiler.is_compiling():
        return
    fn = cuda.load('marks').launch_mark
    if fn.argtypes is None:
        fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_void_p], ctypes.c_int
    err = fn(i, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f'{name} launch failed: CUDA error {err}')


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` over the block, host and (where there is a card)
    CUDA activity; at its end a Chrome trace is written under ``log_dir``
    by ``tensorboard_trace_handler``, which TensorBoard's profile plugin
    reads. The program's spans and phase marks (the module docstring)
    appear in it. Yields the profiler."""
    from torch.profiler import (
        ProfilerActivity, profile, tensorboard_trace_handler)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities,
                   on_trace_ready=tensorboard_trace_handler(log_dir))
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()


def start_server(port: int = 9999):
    """JAX's live profiler server has no PyTorch counterpart: PyTorch
    profiles a block of the program (:func:`trace`), not a process that a
    tool connects to."""
    raise NotImplementedError(
        'PyTorch has no live profiler server to start on port '
        f'{port}; wrap the steps in utils.profiling.trace(log_dir) instead')


def _cuda_devices(tree, found: set) -> set:
    if isinstance(tree, torch.Tensor):
        if tree.is_cuda:
            found.add(tree.device)
    elif isinstance(tree, dict):
        for v in tree.values():
            _cuda_devices(v, found)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _cuda_devices(v, found)
    return found


class StepTimer:
    """Wall-clock step timer that waits for the card at the end of each
    block: the block registers its step's tensors with :meth:`sync`, and
    leaving it synchronizes every CUDA device they lie on."""

    def __init__(self):
        self.times: List[float] = []
        self._t0: Optional[float] = None
        self._pending = None

    def sync(self, outputs):
        """Register this step's outputs (tensors, or dicts, lists and
        tuples of them) to wait for; returns them unchanged."""
        self._pending = outputs
        return outputs

    def __enter__(self):
        self._pending = None
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if exc[0] is None and self._pending is not None:
            for device in _cuda_devices(self._pending, set()):
                torch.cuda.synchronize(device)
        self._pending = None
        self.times.append(time.perf_counter() - self._t0)
        return False

    def summary(self, skip_warmup: int = 1) -> dict:
        """Step count and the mean, median and 95th percentile in ms of the
        steps after the first ``skip_warmup`` (all of them when none is
        left)."""
        ts = np.asarray(self.times[skip_warmup:] or self.times)
        return {
            'steps': len(self.times),
            'mean_ms': float(ts.mean() * 1e3),
            'p50_ms': float(np.percentile(ts, 50) * 1e3),
            'p95_ms': float(np.percentile(ts, 95) * 1e3),
        }
