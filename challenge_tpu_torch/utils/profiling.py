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
"""

from __future__ import annotations

import contextlib
import time
from typing import List, Optional

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` over the block, host and (where there is a card)
    CUDA activity; at its end a Chrome trace is written under ``log_dir``
    by ``tensorboard_trace_handler``, which TensorBoard's profile plugin
    reads. Yields the profiler."""
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
