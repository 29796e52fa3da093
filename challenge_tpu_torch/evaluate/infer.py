"""Sliding-window inference and the challenge evaluation loop (counterpart:
``challenge_tpu/evaluate/infer.py``; reference: metrics.py:31-90).

Per clip: WAV -> complex spectrogram (``ops/dsp.py``) -> channel map ->
eval STFT filter -> magnitude -> mel -> minmax -> log (for the se family
instead: the DC row dropped and the real half kept) -> windows of
``n_frame`` frames every ``overlap_hop`` -> model forward over all windows
at once (the se cascade's class head) -> label-rate upsampling ->
overlap-add averaged by the window count -> 31-frame average pool ->
124-frame max pool -> ``>= 0.5``; then events and the per-clip ER on the
host (``events.py``). The JAX package's one-program dev-set path
with ``n_valid`` masks is an XLA device and is not ported; JAX's own tests
pin its grids equal to the per-clip path ported here.

Reference quirks kept, as in JAX (infer.py:10-17):
* eval always applies the ~1 kHz ``stft_filter`` (rows 1..16 zeroed), even
  though training applies it only for runs named ``filter``;
* ``minmax`` runs over the unbatched [mel, time, chan] tensor, so per mel
  row;
* the average pool divides by the count of in-bounds frames (Keras
  'same'), and the max pool pads 61 frames before and 62 after with -inf,
  as TF's 'SAME' does for an even window;
* the channel maps: n_chan 1 is the identity (``mono_chan`` without
  labels) and the model reads channel 0; n_chan 3 is ``stereo_mono``;
  n_chan > 3 merges with a fresh factor per clip.
The merge factor of clip i (in sorted path order) comes from a CPU
``torch.Generator`` seeded with i: deterministic across runs and devices,
but not JAX's stream, which folds i into ``PRNGKey(0)`` (ROADMAP C). The
vad and se v9 families are ported; the eff family waits for ROADMAP A12.
"""

from __future__ import annotations

import json
import os
from glob import glob

import numpy as np
import torch
import torch.nn.functional as F

from challenge_tpu_torch.data.labels import (
    speech_enhancement_preprocess, stereo_mono)
from challenge_tpu_torch.data.pipeline import LABEL_DOWNSAMPLE_MODELS
from challenge_tpu_torch.evaluate.events import (
    get_er, get_start_end_frame, output_to_metric)
from challenge_tpu_torch.models.layers import avg_pool_same
from challenge_tpu_torch.ops.augment import merge_factors, random_merge_aug
from challenge_tpu_torch.ops.dsp import HOP, SR, load_wav
from challenge_tpu_torch.ops.mel import magnitude_to_mel, mel_filterbank
from challenge_tpu_torch.ops.norms import EPSILON, minmax

SMOOTH = int(0.5 * SR) // HOP           # 31 frames: the 0.5 s average pool
FILTER_ROWS = int(round(256 * 1000 / 16000))   # eval stft_filter, rows 1..16


def frame_signal(x, frame_length: int, frame_step: int, axis: int = -2):
    """tf.signal.frame(..., pad_end=True): split ``axis`` into
    [n_frames, frame_length] windows, zero-padding the tail."""
    axis = axis % x.ndim
    t = x.shape[axis]
    n_frames = max(-(-t // frame_step), 1)
    full = (n_frames - 1) * frame_step + frame_length
    x = torch.movedim(x, axis, -1)
    x = F.pad(x, (0, max(full - t, 0)))[..., :full]
    windows = x.unfold(-1, frame_length, frame_step)   # [..., W, frame_len]
    return torch.movedim(windows, (-2, -1), (axis, axis + 1))


def overlap_and_add(frames, frame_step: int):
    """tf.signal.overlap_and_add: [..., n_frames, frame_len] ->
    [..., (n_frames - 1) * step + frame_len], frames added in order."""
    nf, fl = frames.shape[-2:]
    out = frames.new_zeros(frames.shape[:-2] + ((nf - 1) * frame_step + fl,))
    for i in range(nf):
        out[..., i * frame_step:i * frame_step + fl] += frames[..., i, :]
    return out


def max_pool_1d_same(x, pool: int):
    """Keras MaxPooling1D(pool, 1, 'same') over the time axis of [T, C]:
    TF pads ``(pool - 1) // 2`` before and the rest after, with -inf."""
    lo = (pool - 1) // 2
    xp = F.pad(x.T[None], (lo, pool - 1 - lo), value=float('-inf'))
    return F.max_pool1d(xp, pool, 1)[0].T


def channel_map(config, spec, clip_index: int = 0):
    """The eval channel map of ``config.n_chan`` on a complex spectrogram
    [freq, T, 4] (infer.py:139-145): the identity for n_chan 1 and 2,
    ``stereo_mono`` for 3, and for more a random merge whose factors come
    from a CPU generator seeded with ``clip_index``."""
    if config.n_chan == 3:
        return stereo_mono(spec)
    if config.n_chan > 3:
        gen = torch.Generator().manual_seed(clip_index)
        factor = merge_factors(gen, 1, config.n_chan)[0].to(spec.device)
        return random_merge_aug(spec, factor)
    return spec


@torch.no_grad()
def spec_to_scores(config, module, spec, overlap_hop: int = 512,
                   clip_index: int = 0):
    """Complex spectrogram [freq, T, 4] -> smoothed class scores [T', C]
    (T' = min(T, frames the windows cover)), before the 0.5 threshold
    (counterpart: the body of ``_make_spec_to_grid``, infer.py:138-199,
    with ``n_valid=None``). ``clip_index`` seeds the n_chan > 3 merge."""
    if config.model_type == 'eff':
        raise NotImplementedError(
            'evaluating the eff family is not ported yet (ROADMAP A12)')
    spec = channel_map(config, spec, clip_index)
    n_frame = config.n_frame
    se = config.model_type == 'se'
    if se:
        x = speech_enhancement_preprocess(spec)      # [256, T, chan / 2]
    else:
        keep = torch.ones(spec.shape[0], device=spec.device)
        keep[1:FILTER_ROWS + 1] = 0.0
        spec = spec * keep[:, None, None]             # eval stft_filter
        half = spec.shape[-1] // 2
        re, im = spec[..., :half], spec[..., half:]
        mag = torch.sqrt(re * re + im * im)           # [freq, T, chan]
        melm = torch.tensor(mel_filterbank(config.n_mels, spec.shape[0]),
                            device=spec.device)
        x = torch.log(minmax(magnitude_to_mel(mag, melm)) + EPSILON)

    frame_len = x.shape[-2]
    windows = frame_signal(x, n_frame, overlap_hop, axis=-2)
    windows = windows.permute(1, 0, 2, 3)             # [W, mel, n_frame, chan]
    covered = (windows.shape[0] - 1) * overlap_hop + n_frame
    module.eval()
    preds = module(windows[..., :config.n_chan].contiguous())   # [W, T, C]
    if se:
        preds = preds[0]                              # the class head
    if config.v in LABEL_DOWNSAMPLE_MODELS:
        preds = torch.repeat_interleave(preds, n_frame // preds.shape[-2],
                                        dim=-2)       # UpSampling1D
    preds = preds.permute(2, 0, 1)                    # [C, W, T]
    counts = overlap_and_add(torch.ones_like(preds), overlap_hop)
    preds = overlap_and_add(preds, overlap_hop)
    preds = (preds / counts)[..., :min(frame_len, covered)].T   # [T', C]
    preds = avg_pool_same(preds[None], SMOOTH, 1)[0]
    return max_pool_1d_same(preds, SMOOTH * 4)


def clip_scores(config, module, path: str, overlap_hop: int = 512,
                clip_index: int = 0):
    """The smoothed scores of one WAV file, on the module's device."""
    device = next(module.parameters()).device
    return spec_to_scores(config, module, load_wav(path, device=device),
                          overlap_hop, clip_index)


def evaluate(config, module, overlap_hop: int = 512, verbose: bool = False,
             eval_dir: str = '.'):
    """Challenge evaluation of ``module`` (the model, weights loaded) over
    ``eval_dir/*.wav`` against the ``task2_answer`` of
    ``eval_dir/sample_answer.json`` (reference: metrics.py:31-90). Returns
    the per-clip ER list, in sorted path order. Runs on the module's
    device."""
    with open(os.path.join(eval_dir, 'sample_answer.json')) as f:
        answer_gt = json.load(f)['task2_answer']
    to_metric = output_to_metric(HOP, SR)
    final_score = []
    paths = sorted(glob(os.path.join(eval_dir, '*.wav')))
    for i, path in enumerate(paths):
        scores = clip_scores(config, module, path, overlap_hop, i)
        grid = (scores >= 0.5).float().cpu().numpy()
        cls0, cls1, cls2 = get_start_end_frame(grid)
        gt = np.asarray(answer_gt[os.path.basename(path)[:-4]])
        final_score.append(get_er(gt, to_metric(cls0, cls1, cls2)))
    if verbose:
        print('FINAL SCORE:', np.mean(final_score))
    return final_score
