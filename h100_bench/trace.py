"""The traced window of a ``--trace 1`` run and what is read from it.

``Tracer(on)`` runs ``torch.profiler`` (CPU and CUDA activity) over the
window and records the benchmark's own host spans (``record_function``
around its calls into the program: ``fit.epoch``, ``fit.train``,
``fit.val``, ``pipeline.next``). Off, it records nothing and its spans
cost nothing. :meth:`Tracer.result` reads the profiler's raw events once:
every device operation (kernel, copy, set) as an interval, and the spans.
From those, :class:`Trace` gives the device-busy seconds
(the union of the intervals inside the window), the operations that took
most device time, and the longest idle gaps, each named by the innermost
span the host was in when the gap began.
"""

from __future__ import annotations

import contextlib
import time
from typing import List, NamedTuple, Tuple

import torch

SPAN_PREFIXES = ('fit.', 'pipeline.', 'h100_bench.')
NAME_CHARS = 120      # kernel names in the breakdown are cut to this


class Trace(NamedTuple):
    ops: List[Tuple[str, int, int]]        # device operations (ns)
    spans: List[Tuple[str, int, int]]      # the benchmark's host spans
    window: Tuple[int, int]                # the traced window (ns)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def union(self) -> List[Tuple[int, int]]:
        """The device-busy intervals inside the window, merged."""
        lo, hi = self.window
        out: List[List[int]] = []
        for _, s, e in sorted(self.ops, key=lambda o: o[1]):
            s, e = max(s, lo), min(e, hi)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [tuple(x) for x in out]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.union()) / 1e9

    def op_seconds(self, contains: str = '') -> List[float]:
        """The device seconds of each operation whose name holds
        ``contains``, inside the window."""
        lo, hi = self.window
        return [(e - s) / 1e9 for n, s, e in self.ops
                if contains in n and s >= lo and e <= hi]

    def top_ops(self, n: int = 10):
        total = {}
        lo, hi = self.window
        for name, s, e in self.ops:
            if s >= lo and e <= hi:
                total[name] = total.get(name, 0) + (e - s)
        best = sorted(total.items(), key=lambda kv: -kv[1])[:n]
        return [[k[:NAME_CHARS], v / 1e9] for k, v in best]

    def idle_gaps(self, n: int = 10):
        """The ``n`` longest device-idle gaps in the window, each named by
        the innermost span open on the host at its start."""
        lo, hi = self.window
        busy = self.union()
        edges = [lo] + [x for iv in busy for x in iv] + [hi]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for s, e in gaps[:n]:
            open_spans = [sp for sp in self.spans if sp[1] <= s < sp[2]]
            name = max(open_spans, key=lambda sp: sp[1])[0] \
                if open_spans else 'outside spans'
            out.append([name, (e - s) / 1e9])
        return out


def _annotation(ev) -> bool:
    """Whether a device-side event is a user annotation (a host range
    copied onto the device's timeline) and not an operation."""
    flag = getattr(ev, 'is_user_annotation', None)
    return bool(flag()) if flag is not None else False


class Tracer:
    def __init__(self, on: bool):
        self.on = on
        self.prof = None
        self.read_s = 0.0

    def span(self, name: str):
        if not self.on:
            return contextlib.nullcontext()
        return torch.profiler.record_function(name)

    @contextlib.contextmanager
    def window(self):
        """Profiles the block, if on."""
        if not self.on:
            yield
            return
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        with self.prof:
            with self.span('h100_bench.window'):
                yield
                if torch.cuda.is_available():
                    torch.cuda.synchronize()

    def result(self) -> Trace:
        """The traced window's events; None when off. Reads the profiler's
        raw events, not its parsed event list, which builds an object and a
        tree entry for each of the window's some 100,000 kernels."""
        if self.prof is None:
            return None
        t0 = time.perf_counter()
        ops, spans = [], []
        cuda = torch.autograd.DeviceType.CUDA
        for ev in self.prof.profiler.kineto_results.events():
            name = ev.name()
            if name.startswith(SPAN_PREFIXES):
                # a span, and its copy on the device's timeline, which
                # covers the device's idle time too
                if ev.device_type() != cuda:
                    spans.append((name, ev.start_ns(), ev.end_ns()))
            elif ev.device_type() == cuda and not _annotation(ev):
                ops.append((name, ev.start_ns(), ev.end_ns()))
        window = [sp for sp in spans if sp[0] == 'h100_bench.window']
        bounds = (window[0][1], window[0][2]) if window else (0, 0)
        self.read_s = time.perf_counter() - t0
        return Trace(ops, spans, bounds)
