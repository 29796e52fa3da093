"""Serving artifacts through ``torch.export`` (counterpart:
``challenge_tpu/interop/aot.py``, which serializes StableHLO with
``jax.export``; reference: eval.py:63-65 rebuilds the model in Python
before ``load_weights``).

:func:`export_infer` exports the eval-mode forward of a model with its
weights inside; :func:`export_eval` the whole eval chain of
``evaluate.infer.devset_infer_body``, raw PCM to thresholded frame grids.
Each writes ``torch.export.save`` bytes, and :func:`load_infer` gives back
a callable (``torch.export.load(...).module()``) that needs neither this
package nor a checkpoint.

The batch (or clip) axis is symbolic (``torch.export.Dim``) unless pinned,
so one artifact serves many sizes, as JAX's does. ``torch.export``
specializes sizes 0 and 1, so the axis is declared from 2 up; the loaded
module does not check that bound, and at batch 1 it gives the module's
outputs (tests/test_torch_aot.py holds 1, 2 and 5). A batch of 0 fails. A
pinned axis refuses any other size. The port's recurrent layers loop over
time in Python (``models/layers.py`` ``LSTM``, ``GRU``), so their graphs
hold one copy of the cell per frame and direction: vad v9's BiLSTM over
512 frames exports as 1,024 cell steps.
"""

from __future__ import annotations

import io
from typing import Optional, Union

import torch
from torch import nn


class _EvalChain(nn.Module):
    """``devset_infer_body`` of ``config`` over ``module``'s weights."""

    def __init__(self, config, module: nn.Module, overlap_hop: int):
        super().__init__()
        self.config = config
        self.model = module
        self.overlap_hop = overlap_hop

    def forward(self, pcm, lens, seeds=None):
        from challenge_tpu_torch.evaluate.infer import devset_infer_body
        return devset_infer_body(self.config, self.model, pcm, lens, seeds,
                                 self.overlap_hop)


class _Sealed(nn.Module):
    """``inner`` with its weights held as buffers of identifier names.
    The program ``torch.export.load(...).module()`` rebuilds refers to
    each weight by its dotted name as Python attributes, and the port's
    LSTM gate ``if`` (flax's name) is a keyword, so the export traces
    ``inner`` through ``torch.func.functional_call`` over these buffers."""

    def __init__(self, inner: nn.Module):
        super().__init__()
        self.inner = [inner]              # a list: not a submodule
        self.names = {}
        for name, t in (list(inner.named_parameters())
                        + list(inner.named_buffers())):
            safe = 'w_' + name.replace('.', '__')
            self.names[name] = safe
            self.register_buffer(safe, t.detach())

    def forward(self, *args):
        weights = {k: getattr(self, v) for k, v in self.names.items()}
        return torch.func.functional_call(self.inner[0], weights, args)


def _module(bundle_or_module) -> nn.Module:
    return getattr(bundle_or_module, 'module', bundle_or_module)


def _save(program, path: Optional[str]) -> bytes:
    buf = io.BytesIO()
    torch.export.save(program, buf)
    data = buf.getvalue()
    if path is not None:
        with open(path, 'wb') as f:
            f.write(data)
    return data


def export_infer(bundle_or_module, config, path: Optional[str] = None,
                 batch_size: Optional[int] = None) -> bytes:
    """Export the eval-mode forward of a ModelBundle (or its module) for
    inputs ``[B, *input_shape]`` float32 with the weights inside, on the
    module's device. ``batch_size`` None makes B symbolic (2 or more); an
    int pins it. Returns the ``torch.export.save`` bytes, also written to
    ``path`` when given."""
    module = _module(bundle_or_module).eval()
    p = next(module.parameters())
    shape = (config.n_mels if config.model_type != 'se' else 256,
             config.n_frame, config.n_chan)
    x = torch.zeros((batch_size or 2,) + shape, dtype=torch.float32,
                    device=p.device)
    dynamic = None if batch_size else (
        ({0: torch.export.Dim('batch', min=2)},),)   # forward's *args
    with torch.no_grad():
        program = torch.export.export(_Sealed(module), (x,),
                                      dynamic_shapes=dynamic)
    return _save(program, path)


def export_eval(bundle, config, s_max: int, wav_channels: int = 2,
                overlap_hop: int = 512, path: Optional[str] = None,
                n_clips: Optional[int] = None) -> bytes:
    """Export the whole eval chain (counterpart: ``export_eval``,
    aot.py:58-108): ``(pcm int16 [N, wav_channels, s_max], lens int32
    [N])`` -> grids float32 [N, T_row, n_classes], each clip's first
    ``lens // 256 + 1`` rows valid and equal to ``evaluate``'s. For
    n_chan > 3 a third input, ``seeds`` int32 [N], seeds each clip's
    channel merge (``evaluate`` gives clip i the seed i). N is symbolic (2
    or more) unless ``n_clips`` pins it. Runs on the bundle's device."""
    module = _module(bundle).eval()
    device = next(module.parameters()).device
    n = n_clips or 2
    args = [torch.zeros((n, wav_channels, int(s_max)), dtype=torch.int16,
                        device=device),
            torch.full((n,), int(s_max), dtype=torch.int32, device=device)]
    if config.n_chan > 3:
        args.append(torch.arange(n, dtype=torch.int32, device=device))
    dynamic = None
    if not n_clips:
        dim = torch.export.Dim('clips', min=2)
        dynamic = (tuple({0: dim} for _ in args),)   # forward's *args
    with torch.no_grad():
        program = torch.export.export(
            _Sealed(_EvalChain(config, module, overlap_hop)), tuple(args),
            dynamic_shapes=dynamic)
    return _save(program, path)


def load_infer(artifact: Union[str, bytes]):
    """The callable of an :func:`export_infer` or :func:`export_eval`
    artifact (a path or its bytes): ``torch.export.load(...).module()``,
    on the device it was exported on."""
    if isinstance(artifact, (bytes, bytearray)):
        artifact = io.BytesIO(artifact)
    return torch.export.load(artifact).module()
