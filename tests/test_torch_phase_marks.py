"""The port's tracing instruments (challenge_tpu_torch/utils/profiling.py):
host spans (``span``) and phase marks (``mark``, csrc/marks.cu).

On the CPU, under ``torch.profiler`` with CPU activity:

* a banks-mode and an iterator-mode ``TrainLoop.fit`` record each span
  once a call: ``fit.train_step`` and ``fit.eval_step`` a step,
  ``fit.readback`` a phase, ``fit.callbacks`` twice an epoch and
  ``pipeline.build`` a batch, inside its step's span; ``StepGraphs``
  (with stand-ins for torch's CUDA graph and stream) records
  ``fit.capture`` inside the step that captures and not in a replay;
* with no profiler running, a span is the shared null context and the
  program never calls ``record_function``;
* a mark on the CPU launches nothing and counts nothing, and the se
  cascade's forward and backward on the CPU call their U-Net marks and
  launch none; ``torch.export`` of the se cascade traces no mark, even
  one sent to a CUDA device;
* the phase mark names are the ones the benchmark's ``metrics/phases.py``
  reads, the layer mark names the ones its ``metrics/unet.py`` reads, and
  csrc/marks.cu's kernels are both, in order; none holds ``synth_``.

On the card (``-m cuda``; skipped elsewhere) a graphed train and eval
step replayed under the profiler runs its marks in order in every replay,
the se cascade's U-Net marks among them.
This file imports no JAX, so the card runs it with ``--noconftest``.
"""

import contextlib
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from challenge_tpu_torch.config import Config
from challenge_tpu_torch.data.pipeline import DevicePipeline, build_banks
from challenge_tpu_torch.models import senet
from challenge_tpu_torch.models.registry import ModelBundle, get_model
from challenge_tpu_torch.models.vad import VADModel
from challenge_tpu_torch.ops import cuda
from challenge_tpu_torch.train import graph as graph_lib
from challenge_tpu_torch.train.callbacks import Callback
from challenge_tpu_torch.train.loop import TrainLoop
from challenge_tpu_torch.train.state import (
    TrainState, init_state, make_eval_step, make_train_step)
from challenge_tpu_torch.utils import profiling
from h100_bench.metrics import phases, unet

N_FRAME, N_MELS = 64, 32
SHAPE = (N_MELS, N_FRAME, 2)
CFG = dict(model_type='vad', v=8, n_mels=N_MELS, n_frame=N_FRAME,
           batch_size=2)
SPANS = ('fit.train_step', 'fit.eval_step', 'fit.capture', 'fit.readback',
         'fit.callbacks', 'pipeline.build')
MARKS_CU = Path(profiling.__file__).resolve().parent.parent / 'csrc' \
    / 'marks.cu'


def _sources(seed=0):
    """(backgrounds, voices, int labels, noises): small [257, T, 4]
    spectrograms."""
    rng = np.random.default_rng(seed)

    def specs(lengths):
        return [rng.standard_normal((257, t, 4)).astype(np.float32)
                for t in lengths]
    return (specs((94, 21, 70)), specs((40, 23, 31, 40, 12)),
            rng.integers(0, 30, size=5), specs((20, 9, 14)))


def _bundle(device='cpu'):
    device = torch.device(device)
    module = VADModel(v=8, base_fsize=8, td_dim=32, n_mels=N_MELS).to(device)
    return ModelBundle(module, SHAPE, Config(**CFG), device)


def _banks():
    return build_banks(*_sources(), n_frame=N_FRAME, device='cpu')


class _Epochs(Callback):
    def __init__(self):
        self.calls = 0

    def on_epoch_begin(self, epoch):
        self.calls += 1

    def on_epoch_end(self, epoch, logs=None):
        self.calls += 1


def _spans(prof):
    """The program's host spans in a profile, as (name, start, end) by
    start (not their copies on the card's timeline)."""
    return sorted(((ev.name(), ev.start_ns(), ev.end_ns())
                   for ev in prof.profiler.kineto_results.events()
                   if ev.name() in SPANS
                   and ev.device_type() != torch.autograd.DeviceType.CUDA),
                  key=lambda s: s[1])


def _count(spans):
    return {name: sum(1 for s in spans if s[0] == name) for name in SPANS}


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _profiled(fn):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return _spans(prof)


def test_banks_mode_fit_records_each_span_once_a_call():
    loop = TrainLoop(_bundle(), seed=3, banks=_banks(), val_banks=_banks())
    cb = _Epochs()
    spans = _profiled(lambda: loop.fit(epochs=2, steps_per_epoch=3,
                                       validation_steps=2, callbacks=[cb],
                                       verbose=0))
    assert _count(spans) == {'fit.train_step': 6, 'fit.eval_step': 4,
                             'fit.capture': 0, 'fit.readback': 4,
                             'fit.callbacks': 4, 'pipeline.build': 0}
    assert cb.calls == 4 and loop.state.step == 6


def test_iterator_mode_fit_builds_each_batch_inside_its_step():
    cfg = Config(**CFG)
    loop = TrainLoop(_bundle(), seed=3)
    train = DevicePipeline(_banks(), cfg, training=True, seed=1,
                           device='cpu')
    val = DevicePipeline(_banks(), cfg, training=False, seed=1,
                         device='cpu')
    spans = _profiled(lambda: loop.fit(train, epochs=2, steps_per_epoch=3,
                                       validation_iter=val,
                                       validation_steps=2, verbose=0))
    assert _count(spans) == {'fit.train_step': 6, 'fit.eval_step': 4,
                             'fit.capture': 0, 'fit.readback': 4,
                             'fit.callbacks': 4, 'pipeline.build': 10}
    steps = [s for s in spans if s[0] in ('fit.train_step', 'fit.eval_step')]
    for build in (s for s in spans if s[0] == 'pipeline.build'):
        assert sum(_inside(build, step) for step in steps) == 1


def _graph_stand_ins(monkeypatch):
    """torch's CUDA graph, stream and capture replaced by stand-ins: a
    capture records nothing and a replay runs nothing."""
    class Graph:
        def register_generator_state(self, gen):
            pass

        def replay(self):
            pass

    class Stream:
        def __init__(self, device=None):
            pass

        def wait_stream(self, other):
            pass

    monkeypatch.setattr(torch.cuda, 'CUDAGraph', Graph)
    monkeypatch.setattr(torch.cuda, 'graph',
                        lambda g, stream=None: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, 'Stream', Stream)
    monkeypatch.setattr(torch.cuda, 'stream',
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, 'current_stream',
                        lambda device=None: Stream())


def test_capture_is_a_span_inside_the_step_that_captures(monkeypatch):
    module = torch.nn.Linear(3, 1, bias=False)
    state = TrainState(module, torch.optim.SGD(module.parameters(), lr=0.1))
    graphs = graph_lib.StepGraphs()

    def fn(state, batch):
        return {'loss': module(batch).sum().detach()}

    def steps():
        for _ in range(3):
            with profiling.span('fit.train_step'):
                graphs(fn, state, torch.ones(2, 3))

    _graph_stand_ins(monkeypatch)
    spans = _profiled(steps)
    assert graphs.captures == 1
    assert _count(spans)['fit.capture'] == 1
    capture = next(s for s in spans if s[0] == 'fit.capture')
    first = next(s for s in spans if s[0] == 'fit.train_step')
    assert _inside(capture, first)


def test_span_without_a_profiler_never_calls_record_function(monkeypatch):
    def refuse(name):
        raise AssertionError(f'record_function({name!r}) with no profiler')
    monkeypatch.setattr(torch.profiler, 'record_function', refuse)
    assert profiling.span('fit.train_step') is profiling.span('fit.capture')
    assert isinstance(profiling.span('pipeline.build'),
                      contextlib.nullcontext)
    cfg = Config(**CFG)
    loop = TrainLoop(_bundle(), seed=3, banks=_banks(), val_banks=_banks())
    loop.fit(epochs=1, steps_per_epoch=2, validation_steps=1, verbose=0)
    it = iter(DevicePipeline(_banks(), cfg, device='cpu'))
    next(it)
    assert loop.state.step == 2


def test_mark_on_the_cpu_launches_nothing(monkeypatch):
    def refuse(name):
        raise AssertionError(f'{name} loaded on the CPU')
    monkeypatch.setattr(cuda, 'load', refuse)
    cuda.reset_launch_counts()
    for name in profiling.MARKS + profiling.LAYER_MARKS:
        profiling.mark(name, torch.device('cpu'))
    loop = TrainLoop(_bundle(), seed=3, banks=_banks(), val_banks=_banks())
    loop.fit(epochs=1, steps_per_epoch=2, validation_steps=1, verbose=0)
    assert not cuda.LAUNCHES
    with pytest.raises(KeyError):
        profiling.mark('mark_nothing', torch.device('cpu'))


def test_se_forward_on_the_cpu_calls_its_marks_and_launches_none(
        monkeypatch):
    """The se cascade's training forward and backward on the CPU: the
    U-Net's marks are called, in order, on the CPU device, and nothing is
    loaded or launched."""
    def refuse(name):
        raise AssertionError(f'{name} loaded on the CPU')
    called = []

    def recorded(name, device):
        called.append((name, device.type))
        profiling.mark(name, device)
    monkeypatch.setattr(cuda, 'load', refuse)
    monkeypatch.setattr(senet, 'mark', recorded)
    cuda.reset_launch_counts()
    torch.manual_seed(0)
    module = senet.SECascade(pretrain=True).train()
    x = torch.randn(2, 256, 32, 2)
    cls, speech, noise = module(x)
    (cls.sum() + speech.sum() + noise.sum()).backward()
    with torch.no_grad():
        module.eval()(x)
    assert called == [('mark_unet_begin', 'cpu'), ('mark_unet_end', 'cpu'),
                      ('mark_unet_backward_begin', 'cpu'),
                      ('mark_unet_begin', 'cpu'), ('mark_unet_end', 'cpu')]
    assert not cuda.LAUNCHES


def test_se_export_traces_no_mark(monkeypatch):
    """``torch.export`` of the se cascade's eval forward, its marks sent
    to a CUDA device: the traced forward launches none (a ctypes launch
    cannot be traced) and computes the eager forward's outputs, while the
    same mark outside tracing reaches the kernel library."""
    loads = []

    def refuse(name):
        loads.append(name)
        raise AssertionError(f'{name} loaded')

    def on_cuda(name, device):
        profiling.mark(name, torch.device('cuda'))
    torch.manual_seed(0)
    module = senet.SECascade(pretrain=True).eval()
    x = torch.randn(2, 256, 32, 2)
    with torch.no_grad():
        eager = module(x)
        monkeypatch.setattr(cuda, 'load', refuse)
        monkeypatch.setattr(senet, 'mark', on_cuda)
        program = torch.export.export(module, (x,))
        assert not loads
        traced = program.module()(x)
    for a, b in zip(traced, eager):
        assert torch.equal(a, b)
    with pytest.raises(AssertionError):
        senet.mark('mark_unet_begin', torch.device('cpu'))
    assert loads == ['marks']


def test_mark_names_are_the_benchmarks_and_the_kernels():
    assert sorted(profiling.MARKS) == sorted(phases.MARKS)
    assert sorted(profiling.LAYER_MARKS) == sorted(unet.MARKS)
    every = profiling.MARKS + profiling.LAYER_MARKS
    assert len(set(every)) == len(every)
    assert not [m for m in every if 'synth_' in m]
    kernels = re.findall(r'^\s*X\((\w+)\)', MARKS_CU.read_text(), re.M)
    assert tuple(kernels) == every


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (run on the card)')
    return torch.device('cuda')


def _device_marks(prof, names=profiling.MARKS):
    return [ev.name() for ev in sorted(prof.profiler.kineto_results.events(),
                                       key=lambda ev: ev.start_ns())
            if ev.device_type() == torch.autograd.DeviceType.CUDA
            and ev.name() in names]


@pytest.mark.cuda
def test_replays_run_their_marks_in_order(cuda_device):
    """A graphed train step and eval step, captured first (the capture
    under the profiler too), then replayed: each replay runs the step's
    marks in order on the device, and no mark is counted as a launch."""
    bundle = _bundle(cuda_device)
    state = init_state(bundle, 3)
    train, val = make_train_step(bundle), make_eval_step(bundle)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn((2,) + SHAPE, generator=gen, device=cuda_device)
    y = (torch.rand((2, N_FRAME // 32, 3), generator=gen,
                    device=cuda_device) > 0.5).float()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    cuda.reset_launch_counts()
    with torch.profiler.profile(activities=acts) as prof:
        with profiling.span('fit.train_step'):
            train(state, (x, y))
        val(state, (x, y))
        torch.cuda.synchronize()
    assert train.graphs.captures == 1 and val.graphs.captures == 1
    assert _count(_spans(prof))['fit.capture'] == 2
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(3):
            train(state, (x, y))
        for _ in range(2):
            val(state, (x, y))
        torch.cuda.synchronize()
    step = [f'mark_{p}_{e}' for p in ('forward', 'backward', 'update')
            for e in ('begin', 'end')]
    assert _device_marks(prof) == 3 * step + 2 * ['mark_val_forward_begin',
                                                  'mark_val_forward_end']
    assert not [k for k in cuda.LAUNCHES if k.startswith('mark_')]


@pytest.mark.cuda
def test_se_replays_run_their_unet_marks_in_order(cuda_device):
    """The se cascade's graphed pretrain step and eval step: each replay
    runs the U-Net's marks inside its forward, and the U-Net backward's
    mark inside its backward."""
    cfg = Config(model_type='se', v=9, n_frame=32, batch_size=2,
                 pretrain=True)
    bundle = get_model(cfg, device=cuda_device)
    state = init_state(bundle, 3)
    train, val = make_train_step(bundle), make_eval_step(bundle)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn((2, 256, 32, 2), generator=gen, device=cuda_device)
    y = ((torch.rand((2, 1, 3), generator=gen, device=cuda_device) > 0.5)
         .float(),
         torch.randn((2, 256, 32, 1), generator=gen, device=cuda_device),
         torch.randn((2, 256, 32, 1), generator=gen, device=cuda_device))
    train(state, (x, y))
    val(state, (x, y))
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(2):
            train(state, (x, y))
        val(state, (x, y))
        torch.cuda.synchronize()
    assert train.graphs.captures == 1 and val.graphs.captures == 1
    step = ['mark_forward_begin', 'mark_unet_begin', 'mark_unet_end',
            'mark_forward_end', 'mark_backward_begin',
            'mark_unet_backward_begin', 'mark_backward_end',
            'mark_update_begin', 'mark_update_end']
    assert _device_marks(prof, profiling.MARKS + profiling.LAYER_MARKS) \
        == 2 * step + ['mark_val_forward_begin', 'mark_unet_begin',
                       'mark_unet_end', 'mark_val_forward_end']
