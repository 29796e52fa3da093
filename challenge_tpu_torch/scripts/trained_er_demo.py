"""Trained-model quality demonstration (counterpart:
``scripts/trained_er_demo.py``): the challenge ER must improve through real
training, the one end-to-end behaviour no unit parity test composes up to
(reference behaviour: the score metrics.py:31-90 prints after a
sj_train.py:513 fit).

    python -m challenge_tpu_torch.scripts.trained_er_demo [epochs=20] \
        [steps_per_epoch=100] [bank_dtype=float32] [--device cpu]

Synthesizes a 3-class corpus whose classes live in disjoint spectral bands
(harmonic stacks over broadband noise), writes it in the reference's
dataset format, trains vad v8 at the reference defaults (snr -6) through
the ``sj_train`` CLI, and scores the challenge ER on a synthesized dev set
of 6 clips of 60 s before training (``evaluate()``) and after it (the
``eval`` CLI on the best and the SWA checkpoints). The corpus is JAX's,
sample for sample, from the same seed. The run goes to ``cuda`` unless
given ``--device cpu``, and raises without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import tempfile
import time
import wave
from glob import glob

import numpy as np
import torch

from challenge_tpu_torch.cli import eval as eval_cli
from challenge_tpu_torch.cli import sj_train
from challenge_tpu_torch.config import config_from_args
from challenge_tpu_torch.data.pipeline import build_banks
from challenge_tpu_torch.device import resolve_device
from challenge_tpu_torch.evaluate.infer import (
    _wav_headers, devset_infer_body, evaluate)
from challenge_tpu_torch.models.registry import get_model
from challenge_tpu_torch.ops.dsp import wav_to_spec
from challenge_tpu_torch.train.checkpoint import load_weights

SR = 16000
HOP = 256
# class -> fundamental (Hz); disjoint bands well inside the mel range
F0 = (440.0, 1320.0, 3300.0)
# durations are quantized to a few lengths, as JAX's are (one compile of
# its ingest program per length); the draws consume the same random numbers
VOICE_DURS = (0.5, 1.0, 1.5, 2.0)
NOISE_DURS = (0.4, 0.7, 1.0)
SNR = -6


def event_wav(rng, cls, dur_s, sr=SR, amp=0.25):
    """A band-limited harmonic event: fundamental + 2 harmonics, Hann
    attack/release envelope, stereo with a small channel gain skew."""
    n = int(dur_s * sr)
    t = np.arange(n) / sr
    x = np.zeros(n)
    for h, g in ((1, 1.0), (2, 0.5), (3, 0.25)):
        f = F0[cls] * h * float(rng.uniform(0.98, 1.02))
        x += g * np.sin(2 * np.pi * f * t + rng.uniform(0, 2 * np.pi))
    ramp = min(n // 4, sr // 20)
    env = np.ones(n)
    env[:ramp] = np.hanning(2 * ramp)[:ramp]
    env[-ramp:] = np.hanning(2 * ramp)[ramp:]
    x = amp * x * env / np.abs(x).max()
    return np.stack([x, x * float(rng.uniform(0.8, 1.0))])  # [2, n]


def noise_wav(rng, dur_s, sr=SR, amp=0.05):
    """Broadband background: white noise lowpass-shaped by a cumsum."""
    n = int(dur_s * sr)
    x = rng.standard_normal((2, n))
    x = x + 0.5 * np.cumsum(x, axis=1) / np.sqrt(np.arange(1, n + 1))
    return (amp * x / np.abs(x).max()).astype(np.float64)


def spec_of(wav, device=None):
    """The ingest chain (``ops.dsp.wav_to_spec``) of a float waveform on
    ``device``: a numpy complex spectrogram [257, T, 4]."""
    x = torch.from_numpy(wav.astype(np.float32)).to(resolve_device(device))
    return wav_to_spec(x, SR).cpu().numpy()


def build_training_banks(rng, n_frame, n_per_class=24, n_bg=4, n_noise=8,
                         device=None):
    """Banks of JAX's in-memory corpus, through ``build_banks``."""
    voices, ids = [], []
    for cls in range(3):
        for _ in range(n_per_class):
            dur = VOICE_DURS[int(rng.integers(0, len(VOICE_DURS)))]
            voices.append(spec_of(event_wav(rng, cls, dur), device))
            ids.append(cls)
    bgs = [spec_of(noise_wav(rng, (n_frame + 64) * HOP / SR), device)
           for _ in range(n_bg)]
    noises = [spec_of(noise_wav(
        rng, NOISE_DURS[int(rng.integers(0, len(NOISE_DURS)))], amp=0.15),
        device) for _ in range(n_noise)]
    labels = np.eye(3, dtype=np.float32)[np.asarray(ids)]
    return build_banks(bgs, voices, labels, noises, n_frame=n_frame,
                       device=device)


def debug_grid_stats(cfg, module, d, label):
    """Mean thresholded prediction inside and outside the true events of
    the dev set in ``d`` (the whole-set chain, ``devset_infer_body``, on
    ``module``'s device), and the fraction above 0.5 of each: separates
    'never fires' from 'fires everywhere'. Prints JAX's line and returns
    the four numbers."""
    with open(os.path.join(d, 'sample_answer.json')) as f:
        answer = json.load(f)['task2_answer']
    paths = sorted(glob(os.path.join(d, '*.wav')))
    lens, chan = _wav_headers(paths)
    pcm = np.zeros((len(paths), chan, int(lens.max())), '<i2')
    for i, p in enumerate(paths):
        with wave.open(p, 'rb') as f:
            raw = np.frombuffer(f.readframes(f.getnframes()), '<i2')
        pcm[i, :, :lens[i]] = raw.reshape(-1, chan).T
    device = next(module.parameters()).device
    with torch.no_grad():
        grids = devset_infer_body(
            cfg, module, torch.from_numpy(pcm).to(device),
            torch.from_numpy(lens.astype(np.int32)).to(device),
            torch.zeros(len(paths), dtype=torch.int64,
                        device=device)).cpu().numpy()
    inside, outside = [], []
    for i, p in enumerate(paths):
        stem = os.path.basename(p)[:-4]
        grid = grids[i, :int(lens[i]) // HOP + 1]
        truth = np.zeros_like(grid)
        for cls, s, e in answer[stem]:
            truth[int(s * SR / HOP):int(e * SR / HOP) + 1, int(cls)] = 1
        inside.append(grid[truth > 0])
        outside.append(grid[truth == 0])
    ins = np.concatenate(inside) if inside else np.zeros(1)
    outs = np.concatenate(outside)
    stats = {'p_inside': float(ins.mean()), 'p_outside': float(outs.mean()),
             'frac_inside': float(np.mean(ins > .5)),
             'frac_outside': float(np.mean(outs > .5))}
    print(f'[{label}] p(inside)={stats["p_inside"]:.3f} '
          f'p(outside)={stats["p_outside"]:.3f}'
          f' frac>0.5 inside={stats["frac_inside"]:.3f}'
          f' outside={stats["frac_outside"]:.3f}', flush=True)
    return stats


def write_dev_set(rng, d, n_clips=6, clip_s=60.0, events_per_clip=30):
    """``n_clips`` 16-bit stereo WAVs of ``clip_s`` seconds and their
    ``sample_answer.json`` in ``d``: round-robin events at about the
    background's RMS (JAX's notes on why, scripts/trained_er_demo.py)."""
    answer = {}
    for i in range(n_clips):
        stem = f'clip{i:02d}'
        bg = noise_wav(rng, clip_s)
        events = []
        tcur = 1.0
        for k in range(events_per_clip):
            cls = k % 3
            dur = VOICE_DURS[int(rng.integers(1, len(VOICE_DURS)))]
            if tcur + dur > clip_s - 1.0:
                break
            ev = event_wav(rng, cls, dur, amp=0.03)
            s0 = int(tcur * SR)
            bg[:, s0:s0 + ev.shape[1]] += ev
            events.append([cls, round(tcur, 3), round(tcur + dur, 3)])
            tcur += dur + float(rng.uniform(0.3, 0.9))
        pcm = (np.clip(bg, -1, 1) * 32767).astype('<i2')
        with wave.open(os.path.join(d, f'{stem}.wav'), 'wb') as f:
            f.setnchannels(2)
            f.setsampwidth(2)
            f.setframerate(SR)
            f.writeframes(pcm.T.tobytes())
        answer[stem] = events
    with open(os.path.join(d, 'sample_answer.json'), 'w') as f:
        json.dump({'task2_answer': answer}, f)


def write_training_pickles(rng, d, n_frame, device=None):
    """Spec pickles + label npys in the reference's dataset format
    (reference: sj_train.py:74-90), consumed by the ``sj_train`` CLI."""
    def specs(wavs):
        return [spec_of(w, device) for w in wavs]

    def voice_set(n_per_class):
        voices, ids = [], []
        for cls in range(3):
            for _ in range(n_per_class):
                dur = VOICE_DURS[int(rng.integers(0, len(VOICE_DURS)))]
                voices.append(event_wav(rng, cls, dur))
                ids.append(cls)
        return specs(voices), np.asarray(ids) * 10   # //10 remap quirk

    voices, ids = voice_set(24)
    test_voices, test_ids = voice_set(8)
    bgs = specs([noise_wav(rng, (n_frame + 64) * HOP / SR)
                 for _ in range(4)])
    test_bgs = specs([noise_wav(rng, (n_frame + 64) * HOP / SR)
                      for _ in range(2)])
    noises = specs([noise_wav(
        rng, NOISE_DURS[int(rng.integers(0, len(NOISE_DURS)))], amp=0.15)
        for _ in range(8)])
    for fname, obj in [('bg.pickle', bgs), ('voice.pickle', voices),
                       ('noise.pickle', noises), ('test_bg.pickle', test_bgs),
                       ('test_voice.pickle', test_voices)]:
        with open(os.path.join(d, fname), 'wb') as f:
            pickle.dump(obj, f)
    np.save(os.path.join(d, 'labels.npy'), ids)
    np.save(os.path.join(d, 'test_labels.npy'), test_ids)


def demo(d, device=None, epochs=20, steps=100, bank_dtype='float32',
         n_clips=6, clip_s=60.0, flags=()):
    """The demonstration in directory ``d`` on ``device`` (default
    ``cuda``): the corpus, the untrained score, the ``sj_train`` fit and
    the ``eval`` CLI on the best and the SWA checkpoints, with JAX's
    printed lines. ``flags`` are more ``sj_train`` flags, after JAX's (a
    smaller model: ``--n_mels``, ``--n_frame``, ``--batch_size``). Returns
    the run name, the per-clip ERs (``untrained``, ``best``, ``swa``),
    the grid statistics before and after training and the fit's wall
    seconds."""
    device = resolve_device(device)
    rng = np.random.default_rng(0)
    argv = ['--name', 'erdemo', '--model_type', 'vad', '--v', '8',
            '--snr', str(SNR), '--epochs', str(epochs),
            '--steps_per_epoch', str(steps), '--bank_dtype', bank_dtype,
            '--datapath', d,
            '--background_sounds', 'bg.pickle',
            '--voices', 'voice.pickle', '--labels', 'labels.npy',
            '--noises', 'noise.pickle',
            '--test_background_sounds', 'test_bg.pickle',
            '--test_voices', 'test_voice.pickle',
            '--test_labels', 'test_labels.npy', *flags,
            '--device', str(device)]
    cfg = config_from_args(argv, extra=sj_train.DEVICE_FLAG)
    run = cfg.run_name()
    print(f'config: {run}')
    bundle = get_model(cfg, device=device)
    write_dev_set(rng, d, n_clips, clip_s)
    write_training_pickles(rng, d, cfg.n_frame, device)

    # untrained baseline through the same evaluate() the eval CLI uses
    er0 = evaluate(cfg, bundle.module, eval_dir=d)
    print(f'untrained mean ER: {float(np.mean(er0)):.4f}  ({er0})',
          flush=True)
    out = {'run': run, 'untrained': er0, 'stats': {
        'untrained': debug_grid_stats(cfg, bundle.module, d, 'untrained')}}

    # the reference workflow: the sj_train fit (the {run}/_SWA/_sample trio
    # and the CSV log; the eval callback scores this dev set at epochs 2,
    # 7, ...), then the eval CLI on the trio
    cwd = os.getcwd()
    os.chdir(d)
    try:
        t0 = time.perf_counter()
        sj_train.main(argv)
        out['fit_s'] = time.perf_counter() - t0
        print(f'fit wall {out["fit_s"]:.1f}s for {epochs}x{steps} steps')
        for suffix, key in (('', 'best'), ('_SWA', 'swa')):
            scores = eval_cli.main(['--name', run + suffix, '--p',
                                    '--device', str(device)])
            print(f'trained mean ER ({suffix or "best"}): '
                  f'{float(np.mean(scores)):.4f}  ({scores})', flush=True)
            out[key] = scores
            bundle.module.load_state_dict(
                load_weights(f'{run}{suffix}.h5', device, bundle))
            label = f'trained{suffix or "_best"}'
            out['stats'][label] = debug_grid_stats(cfg, bundle.module, d,
                                                   label)
    finally:
        os.chdir(cwd)
    return out


def main(argv=None):
    """JAX's command line, plus ``--device``; returns :func:`demo`'s
    result."""
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('epochs', nargs='?', type=int, default=20)
    parser.add_argument('steps', nargs='?', type=int, default=100)
    # the bank storage dtype (float32|bfloat16|int8): the int8 run is the
    # quantized-bank accuracy check (the same ER as float32)
    parser.add_argument('bank_dtype', nargs='?', default='float32')
    parser.add_argument('--device', default=None,
                        help="'cpu', or a CUDA device (default)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    with tempfile.TemporaryDirectory(prefix='er_demo_') as d:
        return demo(d, device, args.epochs, args.steps, args.bank_dtype)


if __name__ == '__main__':
    main()
