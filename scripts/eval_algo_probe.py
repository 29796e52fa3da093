#!/usr/bin/env python3
"""Probe of chip_smoke.py phase 8's card-vs-float64 eval check on one CUDA
card: where does the card's distance from float64 come from?

    python3 scripts/eval_algo_probe.py [--seeds 4] [--convs-only]

Phase 8 scores two 8 s clips with a briefly trained vad v8 on the card,
on the CPU in float32 and on the CPU in float64, after setting the BN
statistics to the dev set's windows and shifting the output bias so that
the model predicts events; it holds the card's scores within 10 times the
CPU float32's distance from float64. The card computes its log-mel
windows on the card from the CPU's spectrogram; the CPU's float32 and
float64 scores share the CPU's float32 windows.

Each run here, in a fresh process (cuDNN keeps the algorithms it picked
for a shape for the life of a process), trains vad v8 from one seed as
phase 7's CLI run does (int8 banks from ``chip_smoke.sources``, banks mode
through the graphed fused step, 3 epochs of 5 steps), then follows phase
8 and measures apart:

* ``score_gaps``: phase 8's gaps over the peak (``card``, ``cpu``) and
  whether the card's holds the 10x rule;
* ``window_gaps``: the largest |card - CPU| of the log-mel windows each
  device computes from one WAV end to end (its own STFT included), the
  CPU float32's from a float64 chain, and how many elements differ by
  more than 0.01 (``log(minmax(x) + 1e-8)`` turns a rounding difference
  of a value near its row's minimum into a large one);
* ``output_gaps``: the model's outputs over the peak against the float64
  model on the CPU's float32 windows: the CPU's (``cpu``), the card's on
  the CPU's windows (``card_model``: the model alone) and the card's on
  its own end-to-end windows (``card_features``); and the float64 model
  on float64 windows against it (``f64_features``).

Runs: ``--seeds`` with ``cudnn.benchmark`` on (as the entry points set
it), then seed 0 with it off and seed 0 with ``cudnn.deterministic``; the
names and device times of the convolution kernels of each card eval
forward (torch.profiler). First, each of vad v8's 3x3 convolutions alone
at its eval shape (batch 4): the float32 result's distance from float64,
largest and RMS over the peak, on the card and on the CPU (``CONV``
lines; ``--convs-only`` stops there). One JSON line a run, then the
summary with the card's name and power limit; all of it in
``chiprun_out/eval_algo_probe/probe.json``.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import subprocess
import sys
import tempfile
import wave
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / 'chiprun_out' / 'eval_algo_probe'
CUT_S, SR = 8, 16000


def log_mel_f64(cfg, spec):
    """``infer.spec_to_scores``' feature chain in float64 on the CPU."""
    import torch
    from challenge_tpu_torch.evaluate import infer
    from challenge_tpu_torch.ops.mel import mel_filterbank
    from challenge_tpu_torch.ops.norms import EPSILON, minmax
    spec = spec.double()
    keep = torch.ones(spec.shape[0], dtype=torch.float64)
    keep[1:infer.FILTER_ROWS + 1] = 0.0
    spec = spec * keep[:, None, None]
    half = spec.shape[-1] // 2
    mag = torch.sqrt(spec[..., :half] ** 2 + spec[..., half:] ** 2)
    melm = torch.tensor(mel_filterbank(cfg.n_mels, spec.shape[0]),
                        dtype=torch.float64)
    x = torch.log(minmax(torch.einsum('ftc,fm->mtc', mag, melm)) + EPSILON)
    w = infer.frame_signal(x, cfg.n_frame, 512, axis=-2).permute(1, 0, 2, 3)
    return w[..., :cfg.n_chan].contiguous()


def train(cfg, seed: int, dev):
    """vad v8 after 3 epochs of 5 steps on int8 banks, as phase 7's run."""
    from chip_smoke import sources
    from challenge_tpu_torch import TrainLoop, build_banks, get_model
    banks = build_banks(*sources(seed, 32, 1875, 512, (40, 130), 128,
                                 (20, 100)), n_frame=cfg.n_frame,
                        flat_dtype='int8', device=dev)
    loop = TrainLoop(get_model(cfg, device=dev), seed=seed, banks=banks,
                     val_banks=banks)
    loop.fit(epochs=3, steps_per_epoch=5, validation_steps=1, verbose=0)
    return loop.state.module


def worker(d: str, mode: str, seed: int) -> dict:
    """One run of phase 8's procedure in this process; ``mode`` is
    'benchmark', 'heuristic' or 'deterministic'."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, str(ROOT))
    from chip_smoke import clip_windows, event_bias_shift, write_wav
    from challenge_tpu_torch import Config, get_model
    from challenge_tpu_torch.evaluate import infer
    from challenge_tpu_torch.models.layers import BatchNorm
    from challenge_tpu_torch.ops.dsp import load_wav

    dev = torch.device('cuda', 0)
    cfg = Config(model_type='vad', v=8)
    card = train(cfg, seed, dev)
    cpu = get_model(cfg, device='cpu').module
    # after the entry points, which set benchmark on
    torch.backends.cudnn.benchmark = mode != 'heuristic'
    torch.backends.cudnn.deterministic = mode == 'deterministic'
    names = sorted(p for p in os.listdir(d) if p.startswith('dev'))
    paths = []
    for i in range(2):
        with wave.open(os.path.join(d, names[i]), 'rb') as f:
            pcm = np.frombuffer(f.readframes(CUT_S * SR),
                                '<i2').reshape(-1, 2)
        paths.append(os.path.join(d, f'cut{i:02d}_{os.getpid()}.wav'))
        write_wav(paths[-1], pcm)
    x = clip_windows(cfg, card, [os.path.join(d, n) for n in names])
    bns = [m for m in card.modules() if isinstance(m, BatchNorm)]
    logits = []
    with torch.no_grad():
        for m in bns:
            m.momentum = 0.0
        card.train()(x)
        for m in bns:
            m.momentum = 0.99
        last = card.fcs[-1].dense
        hook = last.register_forward_hook(
            lambda mod, args, out: logits.append(out))
        card.eval()(clip_windows(cfg, card, paths))
        hook.remove()
        shift, _ = event_bias_shift(
            logits[-1].reshape(-1, last.out_features).cpu())
        last.bias += shift.to(dev)
    cpu.load_state_dict(card.state_dict())
    ref = copy.deepcopy(cpu).double()
    score = {'card': 0.0, 'cpu': 0.0}
    window = {'card_vs_cpu': 0.0, 'cpu_vs_f64': 0.0,
              'card_vs_cpu_over_0.01': 0, 'cpu_vs_f64_over_0.01': 0}
    output = {'cpu': 0.0, 'card_model': 0.0, 'card_features': 0.0,
              'f64_features': 0.0}
    kernels = {}
    with torch.no_grad():
        for path in paths:
            spec = load_wav(path, device='cpu')
            f64 = infer.spec_to_scores(cfg, ref, spec)
            w_cpu = clip_windows(cfg, cpu, [path])
            f32 = infer.spec_to_scores(cfg, cpu, spec)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                w_card = clip_windows(cfg, card, [path])
                got = infer.spec_to_scores(cfg, card, spec.to(dev)).cpu()
                torch.cuda.synchronize()
            for e in prof.key_averages():
                if e.device_type == torch.autograd.DeviceType.CUDA and any(
                        k in e.key.lower() for k in (
                            'conv', 'gemm', 'fft', 'winograd', 'implicit')):
                    us = getattr(e, 'self_device_time_total',
                                 getattr(e, 'self_cuda_time_total', 0))
                    kernels[e.key[:120]] = kernels.get(e.key[:120], 0) + us
            peak = float(f64.abs().max())
            score['card'] = max(score['card'],
                                float((got - f64).abs().max()) / peak)
            score['cpu'] = max(score['cpu'],
                               float((f32 - f64).abs().max()) / peak)
            w64 = log_mel_f64(cfg, spec)
            for key, a, b in (('card_vs_cpu', w_card.cpu(), w_cpu),
                              ('cpu_vs_f64', w_cpu.double(), w64)):
                diff = (a.double() - b).abs()
                window[key] = max(window[key], float(diff.max()))
                window[key + '_over_0.01'] += int((diff > 0.01).sum())
            base = ref(w_cpu.double())
            peak = float(base.abs().max())
            for key, o in (('cpu', cpu(w_cpu)),
                           ('card_model', card(w_cpu.to(dev)).cpu()),
                           ('card_features', card(w_card).cpu()),
                           ('f64_features', ref(w64))):
                output[key] = max(output[key], float(
                    (o.double() - base).abs().max()) / peak)
            os.remove(path)
    return {'mode': mode, 'seed': seed, 'pid': os.getpid(),
            'score_gaps': dict(score, ratio=score['card'] / max(
                score['cpu'], 1e-30), within_10x=score['card'] <= max(
                    1e-5, 10 * score['cpu'])),
            'window_gaps': window, 'output_gaps': output,
            'conv_kernels_us': dict(sorted(kernels.items(),
                                           key=lambda kv: -kv[1]))}


def conv_errors() -> list:
    """vad v8's 3x3 convolutions alone (full-width eval shapes, batch 4,
    input and weights from a seed): each float32 result's largest and
    RMS distance from a float64 CPU result, over the peak, on the card
    (``cudnn.benchmark`` on) and on the CPU."""
    import torch
    import torch.nn.functional as F
    from challenge_tpu_torch.device import resolve_device
    dev = resolve_device('cuda')
    gen = torch.Generator().manual_seed(0)
    rows = []
    c_in, h, w = 2, 80, 512
    for c_out in (48, 96, 192, 384, 768):
        for cin in (c_in, c_out):
            x = torch.relu(torch.randn(4, cin, h, w, generator=gen,
                                       dtype=torch.float64))
            k = torch.randn(c_out, cin, 3, 3, generator=gen,
                            dtype=torch.float64) / (9 * cin) ** 0.5
            ref = F.conv2d(x, k, padding=1)
            peak = float(ref.abs().max())
            row = {'c_in': cin, 'c_out': c_out, 'hw': [h, w],
                   'terms': 9 * cin}
            for where in ('cpu', 'card'):
                d = dev if where == 'card' else torch.device('cpu')
                got = F.conv2d(x.float().to(d), k.float().to(d),
                               padding=1).double().cpu()
                err = got - ref
                row[where] = {'max': float(err.abs().max()) / peak,
                              'rms': float(err.square().mean().sqrt()
                                           / ref.square().mean().sqrt())}
            row['card_over_cpu_rms'] = row['card']['rms'] / row['cpu']['rms']
            rows.append(row)
        c_in, h, w = c_out, -(-h // 2), -(-w // 2)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument('--seeds', type=int, default=4)
    ap.add_argument('--worker', nargs=3, metavar=('DIR', 'MODE', 'SEED'))
    ap.add_argument('--convs-only', action='store_true',
                    help='only the single-convolution errors')
    args = ap.parse_args()
    if args.worker:
        d, mode, seed = args.worker
        print('PROBE ' + json.dumps(worker(d, mode, int(seed))), flush=True)
        return 0
    sys.path.insert(0, str(ROOT))
    from chip_smoke import write_dev_set
    OUT.mkdir(parents=True, exist_ok=True)
    convs = conv_errors()
    for row in convs:
        print('CONV ' + json.dumps(row), flush=True)
    if args.convs_only:
        return 0
    results = []
    runs = [('benchmark', s) for s in range(args.seeds)] + [
        ('heuristic', 0), ('deterministic', 0)]
    with tempfile.TemporaryDirectory(prefix='eval_probe_') as d:
        write_dev_set(d)
        for mode, seed in runs:
            out = subprocess.run(
                [sys.executable, __file__, '--worker', d, mode, str(seed)],
                capture_output=True, text=True, check=True, timeout=600)
            line = [ln for ln in out.stdout.splitlines()
                    if ln.startswith('PROBE ')][-1]
            results.append(json.loads(line[len('PROBE '):]))
            print(line, flush=True)
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    summary = {'card': smi, 'runs': [
        {k: r[k] for k in ('mode', 'seed', 'score_gaps', 'window_gaps',
                           'output_gaps')} for r in results]}
    (OUT / 'probe.json').write_text(json.dumps(
        {'summary': summary, 'results': results, 'convs': convs}, indent=1))
    print('SUMMARY ' + json.dumps(summary))
    return 0


if __name__ == '__main__':
    sys.exit(main())
