"""Sliding-window inference and the challenge evaluation loop (counterpart:
``challenge_tpu/evaluate/infer.py``; reference: metrics.py:31-90).

Per clip: WAV -> complex spectrogram (``ops/dsp.py``) -> channel map ->
eval STFT filter -> magnitude -> mel -> minmax -> log (for the se family
instead: the DC row dropped and the real half kept) -> windows of
``n_frame`` frames every ``overlap_hop`` -> model forward over all windows
at once (the se cascade's class head) -> label-rate upsampling ->
overlap-add averaged by the window count -> 31-frame average pool ->
124-frame max pool -> ``>= 0.5``; then events and the per-clip ER on the
host (``events.py``).

``evaluate(batched=True)``, the default, runs the whole dev set as one
batched chain instead (counterpart: ``devset_infer_body``,
infer.py:254-486): every clip's int16 PCM zero-filled to the longest,
ingested on the device with its true length as a tensor (the same-rate
resample, RMS over the true samples, the reflect pad around the length),
then the chain above over all clips' windows at once, with every
reduction masked to each clip's valid frames. A clip's first
``lens[i] // 256 + 1`` grid rows are the per-clip path's. The same body is
what ``interop.aot.export_eval`` exports. A corpus of mixed formats, or a
model whose outputs do not cover every frame (eff v5), takes the per-clip
path.

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
The merge factor of clip i (in sorted path order) is
``ops.augment.merge_factors_from_seed(i)``, a hash in tensor ops, so the
exported program computes it too: deterministic across runs and devices,
but not JAX's stream, which folds i into ``PRNGKey(0)`` (ROADMAP C6).

``evaluate(mesh=)`` spreads the work over the ranks of a data-parallel
mesh, every rank calling it (infer.py:124-136, 408-416, 511): the batched
chain pads each chunk's clip count to a multiple of the mesh, each rank
runs its block of the clips and the grids are gathered; the per-clip
chain gives each rank a block of each clip's windows (zero windows pad
the last block and their outputs are dropped before the overlap-add) and
gathers the model's outputs. Every rank returns the same scores.
Upsampling follows the version, as in JAX: v3, v6, v7, v8 and v9 repeat
each output frame 32 times, the others are used as they come out. eff v1
outputs every frame; eff v5 keeps its coarse n_frame * 256 // 16000
frames a window, and the overlap-add leaves each window's other frames
at 0 / 0 (JAX's quirk too, infer.py:87-92), so its grid is mostly
empty.
"""

from __future__ import annotations

import json
import os
import wave
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
from challenge_tpu_torch.ops.augment import (
    merge_factors_from_seed, random_merge_aug)
from challenge_tpu_torch.ops.dsp import (
    HOP, N_FFT, SR, _dft_matrices, load_wav, read_wav_raw, resample_waveform)
from challenge_tpu_torch.ops.mel import magnitude_to_mel, mel_filterbank
from challenge_tpu_torch.ops.norms import EPSILON, minmax, safe_div

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
    """Keras MaxPooling1D(pool, 1, 'same') over the time axis of [..., T, C]
    ([T, C] or [N, T, C]): TF pads ``(pool - 1) // 2`` before and the rest
    after, with -inf."""
    lo = (pool - 1) // 2
    xp = F.pad(x.transpose(-1, -2), (lo, pool - 1 - lo),
               value=float('-inf'))
    return F.max_pool1d(xp, pool, 1).transpose(-1, -2)


def channel_map(config, spec, clip_index=0):
    """The eval channel map of ``config.n_chan`` on a complex spectrogram
    [freq, T, 4], or [N, freq, T, 4] with ``clip_index`` an [N] tensor
    (infer.py:139-145): the identity for n_chan 1 and 2, ``stereo_mono``
    for 3, and for more a random merge whose factors are
    ``merge_factors_from_seed(clip_index)``."""
    if config.n_chan == 3:
        return stereo_mono(spec)
    if config.n_chan > 3:
        seeds = torch.as_tensor(clip_index, device=spec.device).reshape(-1)
        factor = merge_factors_from_seed(seeds, config.n_chan)
        return random_merge_aug(spec, factor[:, None, None]
                                if spec.ndim == 4 else factor[0])
    return spec


def _class_head(config, module, x):
    """The model's eval-mode class scores for the windows ``x``."""
    module.eval()
    preds = module(x.contiguous())
    return preds[0] if config.model_type == 'se' else preds


def _sharded_head(config, module, x, mesh):
    """:func:`_class_head` of ``x`` with its windows split over the ranks
    of ``mesh``: zero windows pad the last block, and their outputs are
    dropped after the gather."""
    if mesh is None:
        return _class_head(config, module, x)
    n = x.shape[0]
    pad = (-n) % mesh.size
    if pad:
        x = torch.cat([x, x.new_zeros((pad,) + x.shape[1:])])
    per = x.shape[0] // mesh.size
    local = _class_head(config, module, x[mesh.rank * per:
                                          (mesh.rank + 1) * per])
    return mesh.all_gather(local)[:n]


@torch.no_grad()
def spec_to_scores(config, module, spec, overlap_hop: int = 512,
                   clip_index: int = 0, mesh=None):
    """Complex spectrogram [freq, T, 4] -> smoothed class scores [T', C]
    (T' = min(T, frames the windows cover)), before the 0.5 threshold
    (counterpart: the body of ``_make_spec_to_grid``, infer.py:138-199,
    with ``n_valid=None``). ``clip_index`` seeds the n_chan > 3 merge;
    with a ``mesh`` the windows are split over its ranks."""
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
    preds = _sharded_head(config, module, windows[..., :config.n_chan],
                          mesh)                       # [W, T, C]
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
                clip_index: int = 0, mesh=None):
    """The smoothed scores of one WAV file, on the module's device."""
    device = next(module.parameters()).device
    return spec_to_scores(config, module, load_wav(path, device=device),
                          overlap_hop, clip_index, mesh)


# ------------------------------------------------- the one-program dev set
class BatchedEvalIneligible(Exception):
    """A model whose outputs do not cover every spectrogram frame (eff v5's
    coarse head): the batched chain cannot hold its grid, and
    :func:`evaluate` takes the per-clip path (infer.py:87-92)."""


# The device bytes the batched chain holds at its peak for each byte of
# int16 PCM, by family: the resample's tap frames, the float32
# spectrogram and STFT frames, and the model's activations over all the
# chunk's windows. Measured on the 6 x 60 s dev set with random weights
# (chip_smoke.py phase 7h, PERF.md §6, NVIDIA H100 80GB HBM3 at
# 700 W): vad v8 95 and v9 542, se v9 1,717 (its U-Net over 48 windows),
# eff B0 v1 47 and B7 v6 81; each family's largest, rounded up. A chunk's
# PCM is capped at BATCH_BUDGET_BYTES over its family's ratio, a tenth of
# the H100's 80 GB, which leaves the rest to the training run whose eval
# callback calls evaluate(): a chunk of vad takes 3 clips of 60 s, of se
# one, of eff 22.
PEAK_PER_PCM_BYTE = {'vad': 600, 'eff': 100, 'se': 1800}
BATCH_BUDGET_BYTES = 8 << 30


def batch_pcm_cap(config) -> int:
    """The PCM bytes of one batched chunk for ``config``'s family."""
    return BATCH_BUDGET_BYTES // PEAK_PER_PCM_BYTE[config.model_type]


def _wav_headers(paths, sr: int = SR):
    """Header-only scan (infer.py:254-271): (sample counts [N], channels),
    or None when the set cannot take the batched path (not 16-bit, not
    ``sr``, mixed channel counts, unreadable)."""
    lens, chans = [], set()
    try:
        for p in paths:
            with wave.open(p, 'rb') as f:
                if f.getsampwidth() != 2 or f.getframerate() != sr:
                    return None
                chans.add(f.getnchannels())
                lens.append(f.getnframes())
    except Exception:
        return None
    if len(chans) != 1:
        return None
    return np.asarray(lens), chans.pop()


def _prepare_batched_pcm(paths, sr: int = SR, n_fft: int = N_FFT,
                         s_max: int = None):
    """The host side (infer.py:274-305): every 16-bit WAV of ``paths``
    zero-filled to the longest clip, or to ``s_max`` samples. Returns
    (pcm int16 [N, chan, S], sample counts int32 [N]), or None for a set
    that cannot take the batched path (another width or rate, mixed
    channels, a clip no longer than the STFT's reflect pad, or longer
    than ``s_max``)."""
    pad = n_fft // 2
    rows = []
    for p in paths:
        raw, rate = read_wav_raw(p)
        if raw is None or rate != sr or raw.shape[1] <= pad:
            return None
        rows.append(raw)
    if len({r.shape[0] for r in rows}) != 1:
        return None
    if s_max is None:
        s_max = max(r.shape[1] for r in rows)
    elif any(r.shape[1] > s_max for r in rows):
        return None
    pcm = np.zeros((len(rows), rows[0].shape[0], s_max), '<i2')
    lens = np.zeros((len(rows),), np.int32)
    for i, r in enumerate(rows):
        pcm[i, :, :r.shape[1]] = r
        lens[i] = r.shape[1]
    return pcm, lens


def pcm_to_specs(pcm, lens):
    """The device side of the ingest (counterpart: ``_pcm_row_to_spec``,
    infer.py:308-345, over all rows at once): int16 PCM [N, chan, S],
    zero-filled past each clip's sample count ``lens`` [N], -> (complex
    spectrograms [N, freq, T_row, chan*2], valid frames [N]). Each row
    takes ``dsp.wav_to_spec``'s chain with its length a tensor: the
    same-rate Kaldi resample, its taps past the length zeroed, RMS/10 over
    the true samples, and the reflect pad around the length, by index
    arithmetic and ``gather`` on the static S (no ``.item()``, no branch on
    a length), so ``torch.export`` traces it. A row's first
    ``lens // 256 + 1`` frames are ``wav_to_spec`` of the clip (up to the
    sums' float32 order)."""
    pad = N_FFT // 2
    s = lens.to(torch.int64)[:, None, None]
    wav = pcm.to(torch.float32) / 32768.0
    res = resample_waveform(wav, SR, SR)
    pos = torch.arange(res.shape[-1], device=res.device)
    res = res * (pos < s)
    denom = (s[:, 0, 0] * res.shape[1]).to(torch.float32)
    rms = torch.sqrt(torch.sum(torch.square(res), dim=(1, 2)) / denom) * 10.0
    res = res / rms[:, None, None]
    # torch.stft(center=True)'s reflect pad around the true length: buffer
    # position q holds signal index k = q - pad, mirrored at 0 and s - 1
    k = torch.arange(-pad, res.shape[-1] + 2 * pad, device=res.device)
    src = torch.where(k < 0, -k, torch.where(k < s, k, 2 * (s - 1) - k))
    src = src.clamp(0, res.shape[-1] - 1).expand(*res.shape[:2], -1)
    buf = torch.gather(res, -1, src) * (k < s + pad)
    cos_m, sin_m = (torch.tensor(m, device=res.device)
                    for m in _dft_matrices())
    frames = buf.unfold(-1, N_FFT, HOP)                # [N, C, T_row, N_FFT]
    spec = torch.stack([frames @ cos_m, frames @ sin_m], dim=1)
    spec = spec.permute(0, 4, 3, 1, 2)                 # [N, freq, T, 2, C]
    return spec.reshape(*spec.shape[:3], -1), lens.to(torch.int64) // HOP + 1


def specs_to_grids(config, module, spec, n_valid, seeds,
                   overlap_hop: int = 512):
    """Complex spectrograms [N, freq, T, 4] with their valid frame counts
    [N] -> thresholded 0/1 grids [N, T, n_classes] (counterpart:
    ``_make_spec_to_grid`` with ``n_valid``, infer.py:138-212): the chain
    of :func:`spec_to_scores` over all clips' windows in one forward, with
    minmax, the features, the average pool and the max pool masked to each
    clip's valid frames, and rows past them 0. ``seeds`` [N] seed the
    n_chan > 3 merges. Raises :class:`BatchedEvalIneligible` for a model
    whose outputs do not cover every frame."""
    spec = channel_map(config, spec, seeds)
    n, n_frame = spec.shape[0], config.n_frame
    t_total = spec.shape[2]
    valid = torch.arange(t_total, device=spec.device) < n_valid[:, None]
    se = config.model_type == 'se'
    if se:
        x = speech_enhancement_preprocess(spec)       # [N, 256, T, chan]
    else:
        keep = torch.ones(spec.shape[1], device=spec.device)
        keep[1:FILTER_ROWS + 1] = 0.0
        spec = spec * keep[:, None, None]             # eval stft_filter
        half = spec.shape[-1] // 2
        re, im = spec[..., :half], spec[..., half:]
        mag = torch.sqrt(re * re + im * im)           # [N, freq, T, chan]
        melm = torch.tensor(mel_filterbank(config.n_mels, spec.shape[1]),
                            device=spec.device)
        x = torch.einsum('nftc,fm->nmtc', mag, melm)
        m = valid[:, None, :, None]
        x_max = torch.where(m, x, float('-inf')).amax(dim=(2, 3),
                                                      keepdim=True)
        x_min = torch.where(m, x, float('inf')).amin(dim=(2, 3),
                                                     keepdim=True)
        x = torch.log(safe_div(x - x_min, x_max - x_min) + EPSILON)
    x = torch.where(valid[:, None, :, None], x, 0.0)

    frame_len = x.shape[-2]
    windows = frame_signal(x, n_frame, overlap_hop, axis=-2)
    n_win = windows.shape[2]                          # [N, mel, W, n_frame, c]
    covered = (n_win - 1) * overlap_hop + n_frame
    windows = windows.permute(0, 2, 1, 3, 4)[..., :config.n_chan]
    module.eval()
    preds = module(windows.reshape(n * n_win, *windows.shape[2:])
                   .contiguous())                     # [N * W, T', C]
    if se:
        preds = preds[0]
    if config.v in LABEL_DOWNSAMPLE_MODELS:
        preds = torch.repeat_interleave(preds, n_frame // preds.shape[-2],
                                        dim=-2)
    preds = preds.reshape(n, n_win, *preds.shape[1:]).permute(0, 3, 1, 2)
    counts = overlap_and_add(torch.ones_like(preds), overlap_hop)
    preds = overlap_and_add(preds, overlap_hop)       # [N, C, T']
    preds = (preds / counts)[..., :min(frame_len, covered)].transpose(1, 2)
    if preds.shape[1] != t_total:
        raise BatchedEvalIneligible(
            f'model output length {preds.shape[1]} != spectrogram frames '
            f'{t_total}: per-clip eval only for this config')
    vm = valid[..., None].to(preds.dtype)             # [N, T, 1]
    lo = (SMOOTH - 1) // 2

    def window_sum(v):
        v = F.pad(v.transpose(1, 2), (lo, SMOOTH - 1 - lo))
        return v.unfold(-1, SMOOTH, 1).sum(-1).transpose(1, 2)
    preds = window_sum(preds * vm) / window_sum(vm.expand_as(preds)).clamp(
        min=1.0)
    preds = max_pool_1d_same(torch.where(vm > 0, preds, float('-inf')),
                             SMOOTH * 4)
    return ((preds >= 0.5) & (vm > 0)).to(torch.float32)


def devset_infer_body(config, module, pcm, lens, seeds=None,
                      overlap_hop: int = 512):
    """The whole dev-set chain (counterpart: ``devset_infer_body``,
    infer.py:348-368): int16 PCM [N, chan, S] and sample counts [N] (and
    for n_chan > 3 the clip seeds [N]; ``None`` is 0, 1, ...) -> grids
    [N, T_row, n_classes], each clip's first ``lens // 256 + 1`` rows
    valid. ``interop.aot.export_eval`` exports this function."""
    if seeds is None:
        seeds = torch.arange(pcm.shape[0], device=pcm.device)
    spec, n_valid = pcm_to_specs(pcm, lens)
    return specs_to_grids(config, module, spec, n_valid, seeds, overlap_hop)


def make_devset_infer_fn(config, module, overlap_hop: int = 512):
    """``fn(pcm, lens[, seeds])`` -> grids: :func:`devset_infer_body` on
    ``module``'s device, without autograd (counterpart:
    ``make_devset_infer_fn``, infer.py:370-417, one card, no mesh)."""
    @torch.no_grad()
    def infer_all(pcm, lens, seeds=None):
        return devset_infer_body(config, module, pcm, lens, seeds,
                                 overlap_hop)
    return infer_all


def _chunk_plan(paths, cap: int, pad_to: int = 1):
    """([chunk of paths, ...], clips a chunk is padded to, forced row
    length) for the batched path (infer.py:509-534), or None for a corpus
    that cannot take it. A corpus within ``cap`` PCM bytes is one chunk;
    a larger one runs as equal chunks of equal row length. The clips a
    chunk is padded to are a multiple of ``pad_to`` (the mesh's size)."""
    hdr = _wav_headers(paths)
    if hdr is None:
        return None
    lens, chan = hdr
    s_max = int(lens.max())
    per_chunk = max(int(cap // max(chan * s_max * 2, 1)), 1)
    if per_chunk >= len(paths):
        return [paths], pad_to, None
    per_chunk = max(per_chunk - per_chunk % pad_to, pad_to)
    return ([paths[i:i + per_chunk] for i in range(0, len(paths), per_chunk)],
            per_chunk, s_max)


def batched_grids(config, module, paths, overlap_hop: int = 512,
                  cap: int = None, mesh=None):
    """The grids of ``paths`` (each cut to its clip's valid rows) from the
    one-program chain, chunk by chunk, or None where the corpus or the
    model cannot take it (counterpart: the batched branch of ``evaluate``,
    infer.py:509-582). A chunk holds at most ``cap`` PCM bytes (default:
    :func:`batch_pcm_cap`); a short one is padded with constant dummy
    clips, as in JAX, so every chunk has one shape. With a ``mesh`` the
    chunk's clips are padded to a multiple of its size, each rank runs its
    block of them, and the grids are gathered."""
    w = 1 if mesh is None else mesh.size
    plan = _chunk_plan(paths, cap or batch_pcm_cap(config), w)
    if plan is None:
        return None
    chunks, clips_to, s_force = plan
    device = next(module.parameters()).device
    infer_all = make_devset_infer_fn(config, module, overlap_hop)
    grids, clip0 = [], 0
    for chunk in chunks:
        prep = _prepare_batched_pcm(chunk, s_max=s_force)
        if prep is None:
            return None
        pcm, lens = prep
        n_pad = (-len(chunk)) % clips_to
        if n_pad:
            pcm = np.concatenate(
                [pcm, np.full((n_pad,) + pcm.shape[1:], 1000, pcm.dtype)])
            lens = np.concatenate([lens, np.full((n_pad,), HOP * 4,
                                                 lens.dtype)])
        seeds = torch.arange(clip0, clip0 + len(pcm), device=device)
        block = slice(None)
        if mesh is not None:
            per = len(pcm) // w
            block = slice(mesh.rank * per, (mesh.rank + 1) * per)
        try:
            out = infer_all(torch.from_numpy(pcm[block]).to(device),
                            torch.from_numpy(lens[block]).to(device),
                            seeds[block])
        except BatchedEvalIneligible:
            return None
        if mesh is not None:
            out = mesh.all_gather(out)
        out = out.cpu().numpy()
        grids.extend(out[i, :int(s) // HOP + 1]
                     for i, s in enumerate(lens[:len(chunk)]))
        clip0 += len(chunk)
    return grids


def evaluate(config, module, overlap_hop: int = 512, verbose: bool = False,
             eval_dir: str = '.', batched: bool = True, mesh=None):
    """Challenge evaluation of ``module`` (the model, weights loaded) over
    ``eval_dir/*.wav`` against the ``task2_answer`` of
    ``eval_dir/sample_answer.json`` (reference: metrics.py:31-90). Returns
    the per-clip ER list, in sorted path order. Runs on the module's
    device. ``batched`` (the default, as in JAX) scores two or more clips
    through :func:`batched_grids` where the corpus and the model allow it,
    else clip by clip; the grids are the same. With a ``mesh`` every rank
    calls it and the work is split over the ranks (the module
    docstring)."""
    with open(os.path.join(eval_dir, 'sample_answer.json')) as f:
        answer_gt = json.load(f)['task2_answer']
    to_metric = output_to_metric(HOP, SR)
    paths = sorted(glob(os.path.join(eval_dir, '*.wav')))
    grids = None
    if batched and len(paths) > 1:
        grids = batched_grids(config, module, paths, overlap_hop, mesh=mesh)
    if grids is None:
        grids = [(clip_scores(config, module, path, overlap_hop, i, mesh)
                  >= 0.5).float().cpu().numpy()
                 for i, path in enumerate(paths)]
    final_score = []
    for path, grid in zip(paths, grids):
        cls0, cls1, cls2 = get_start_end_frame(grid)
        gt = np.asarray(answer_gt[os.path.basename(path)[:-4]])
        final_score.append(get_er(gt, to_metric(cls0, cls1, cls2)))
    if verbose:
        print('FINAL SCORE:', np.mean(final_score))
    return final_score
