#!/usr/bin/env python3
"""Smoke run of challenge_tpu_torch, the PyTorch + CUDA port, on one GPU.

    python3 chip_smoke.py            # needs one CUDA card, nvcc and the repo
    python3 chip_smoke.py --profile  # also a torch.profiler breakdown of the
                                     # vad v8, se and vad v9 steps
    python3 chip_smoke.py --cudnn-ab # also the model step with cuDNN's
                                     # algorithm timing off and on, each in
                                     # a fresh process (off, on, on, off)

Phases, in order; any failure raises, and the script then exits non-zero
without the result line:

1. build every hand-written CUDA kernel from challenge_tpu_torch/csrc with
   nvcc for sm_90a, one nvcc per source, all started together, and print
   the build seconds and ptxas' report for all nine instances (csrc/synth.cu:
   magnitude and flat-complex output; csrc/synth_mel.cu: the fused mel;
   each for float32, bfloat16 and int8 banks);
2. make random spec banks on the card at a realistic size (32 backgrounds
   of 1,875 frames, 512 voices of 40-130 frames, 128 noises of 20-100,
   each [257, T, 4] float32, from a seed), as float32, bfloat16 and int8
   banks from the same sources;
3. hold the float32 magnitude kernel against its plain PyTorch version on
   the card: bit for bit (tolerance 0.0: both round every multiply and add
   of the same ordered sum and take the IEEE root), on draws of the main
   path (batch 12, 512 frames, 7 voice and 2 noise slots) and on
   adversarial draws (negative shifts, shifts of n_frame and beyond,
   inactive slots, long then short clips, no noise bank, a ragged row
   tile);
3b. the same for the bfloat16 and int8 magnitude kernels, on banks built
   from the same sources and on the adversarial cases with their banks
   rounded or quantized: bit for bit (both upcast exactly, sum in float32
   in order, take the IEEE root and round it once to bfloat16);
3c. the same for the three flat-complex kernels (the raw window, rounded
   once to bfloat16 for the low-precision banks), bit for bit, on the main
   path's draws, the adversarial cases and the se triple: the mix with
   every voice weight zeroed, the voices over the one-item zero background
   bank with a unit background scale, and that call with every voice slot
   inactive;
3d. the same for the three fused mel kernels, mel and min/max, bit for
   bit (both take the float32 root, the {0,1} masks and the mel sum over
   the nonzero band in increasing order, every product and sum rounded),
   on the main path's draws (vad v9, batch 12, 512 frames) with training
   masks, eval masks (all ones) and the filter columns, on batch 1, on a
   sample whose time mask zeroes every frame (its min and max must be 0),
   and on the adversarial cases;
4. check the port on the card against the port on the CPU on a small
   input: synthesis bit for bit, log-mel within 1e-5 mean abs error,
   labels exact, and one training-mode forward and loss within 1e-5
   relative;
4b. int8 synthesis on the card against the CPU on that input, bit for bit;
4c. the se path on a small input (batch 2, 32 frames): synthesis, targets
   and features bit for bit against the CPU in each bank dtype; then one
   training-mode forward of the full-width pretrain cascade and
   ``se_loss``, the card's float32 held to a float64 CPU copy within 1e-5
   of each output's peak or 10 times the CPU float32's distance;
4d. the fused mel path on a small input (batch 4, 80 mels, 64 frames):
   the kernel's mel and min/max and the labels bit for bit against the
   CPU on the same draws and masks, the log-mel within 2 float32 ulps
   (each device's own log); then one training-mode forward and loss of
   full-width vad v6, v7 and v9, held to float64 as in 4c;
5. the main path: ``get_model(Config(model_type='vad', v=8))`` at full width
   (base 48, td_dim 1024, 80 mels, 512 frames, batch 12),
   ``DevicePipeline`` and ``TrainLoop.fit`` for 5 training steps and 1
   validation step, with the kernel launch counts set to 0 just before and
   read just after: every batch must have gone through the kernel, and
   the losses must be finite;
5b. the se slice's main path: ``get_model(Config(model_type='se', v=9,
   pretrain=True))`` at full width (U-Net 64-512, head base 32 and td_dim
   1024, input [12, 256, 512, 2]) on float32 banks, ``DevicePipeline`` and
   ``TrainLoop.fit`` for 3 training steps and 1 validation step; then the
   finetune model, given those weights, for the same. Each run's counts
   are set to 0 just before and read just after: the float32 flat-complex
   kernel must have run 3 times a batch and nothing else; the frozen half's
   weights and BN statistics must be bit-identical before and after, every
   tensor of the trained half must move, and the losses (class, speech,
   noise, validation class ER) must be finite;
5c. this slice's main path: ``get_model(Config(model_type='vad', v=9))``
   at full width (base 32, td_dim 1024, 80 mels, 512 frames, batch 12,
   BiLSTM head) trained by ``TrainLoop.fit`` from an iterator over
   ``FeatureFn(cfg, fused_mel=True)`` on float32 banks, 5 training steps and
   1 validation step; then v6 and v7 for 2 steps each on the same path, and
   v9 for 2 steps each on bfloat16 and int8 banks. Each run's counts are
   set to 0 just before and read just after: the mel kernel of the banks'
   dtype must have run once a batch and no other kernel, and every logged
   value must be finite;
5d. full-width vad v8 with n_chan 3 and 4 through ``DevicePipeline``'s
   complex branch, 2 steps each: the float32 flat-complex kernel once a
   batch and nothing else, features and model inputs 3 and 4 wide; and
   n_chan 1, whose card features keep 2 channels (the reference's
   ``mono_chan`` quirk) and whose training raises the port's ValueError;
6. times: each kernel and its plain version in turns (plain, kernel,
   kernel, plain) with CUDA events, their bounds from this run's draws
   (the flat-complex kernels on the se full mix), and the vad training
   step (20 steps of one epoch, read back once, as ``fit`` does), the
   batch pipeline and the model step on their own; the same for the se
   pretrain step (10 steps); then the vad training step in banks mode, as
   the CLI runs it, and the batch pipeline alone, with float32 and int8
   banks in turns (float32, int8, int8, float32), so that only the bank
   dtype differs; the mel kernels against their plain versions in turns,
   with bounds over the band's columns and over all columns; the v9
   fused-mel training step (``v9_step_ms``, 20 steps); and the batch
   pipeline through B1 and the matmul mel (``pipeline_ms``) and through B4
   (``fused_mel_pipeline_ms``) in turns (unfused, fused, fused, unfused);
7. the CLI chain, in a temporary directory: the realistic spec sets as
   pickles under sj_train's default file names, and a dev set of 6
   two-channel 16 kHz WAVs of 60 s with ``sample_answer.json``; then
   ``cli.sj_train.main`` with ``--bank_dtype int8`` for 3 epochs of 5 steps
   (16 validation steps each; the eval callback fires at epoch 2 and SWA
   folds at epoch 1), which must launch the int8 kernel once per batch (63
   times) and write the checkpoint trio and a 3-row CSV; ``cli.eval.main``
   with ``--p``, which must return 6 finite ERs; and ``--bank_dtype
   bfloat16`` for 1 epoch of 5 steps, which must launch the bfloat16
   kernel 21 times. Each run's counts are set to 0 just before it and read
   just after. The eval seconds of the 6 x 60 s dev set are timed;
8. the same ``_SWA.h5`` evaluated on the card and on the CPU over 2 of the
   clips cut to 8 s. The briefly trained model predicts no event, so its
   BN statistics are first set to those of the clips and its output bias
   shifted per class until a tenth of the CPU's output frames over both
   clips lie above 0.5. The smoothed scores must
   agree within 1e-5 of their peak, the 0/1 grids must hold both events
   and silence, any frame whose grid differs must have a score within
   1e-5 of 0.5 (the count of such frames is printed), and the ERs against
   the answers inside each clip's 8 s must be identical;
7b. the se CLI chain in that directory: ``cli.sj_train.main`` with
   ``--model_type se --v 9 --pretrain True --bank_dtype int8`` for 3
   epochs of 2 steps (16 validation steps each), which must launch the
   int8 flat-complex kernel 3 times a batch (162 times) and write the trio
   under the run name ending ``_weight``; that checkpoint copied to the
   finetune run's name, which the finetune run loads (the reference's
   bool flag reads any ``--pretrain`` value as True, so it is left out);
   the finetune run with ``--bank_dtype bfloat16`` for the same epochs,
   162 bfloat16 launches, its trio, and a U-Net bit-identical to the
   pretrain checkpoint's; then ``cli.eval.main`` on the finetuned
   ``_SWA.h5``, which must return 6 finite ERs, timed;
7c. the channel maps' CLI chain in that directory: ``cli.sj_train.main``
   with ``--model_type vad --v 9 --n_chan 3 --bank_dtype int8`` for 3
   epochs of 2 steps (16 validation steps each), which must launch the
   int8 flat-complex kernel once a batch (54 times) and write the trio;
   ``cli.eval.main --p`` on it, and ``evaluate()`` with the n_chan 4 model
   of 5d and an n_chan 1 model from ``get_model``, 6 finite ERs each.

The last lines are the card's name and power limit as nvidia-smi gives
them, one JSON object ``{"kernels": [...]}`` and, last,
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import copy
import json
import math
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time
import wave

import numpy as np
import torch

from challenge_tpu_torch import (
    Config, DevicePipeline, TrainLoop, build_banks, get_model)
from challenge_tpu_torch.cli import eval as eval_cli
from challenge_tpu_torch.cli import sj_train
from challenge_tpu_torch.data import mixture
from challenge_tpu_torch.data.labels import (
    label_downsample, speech_enhancement_preprocess)
from challenge_tpu_torch.data.pipeline import FeatureFn
from challenge_tpu_torch.data.specset import FLAT_DTYPES
from challenge_tpu_torch.evaluate import events, infer
from challenge_tpu_torch.models.layers import BatchNorm
from challenge_tpu_torch.models.senet import SECascade
from challenge_tpu_torch.models.vad import VADModel
from challenge_tpu_torch.ops import cuda
from challenge_tpu_torch.ops.augment import batch_mask_keep
from challenge_tpu_torch.ops.dsp import load_wav
from challenge_tpu_torch.ops.synth import (
    FLAT_KERNELS, KERNELS, MEL_KERNELS, synthesize_flat,
    synthesize_flat_plain, synthesize_magnitude, synthesize_magnitude_plain,
    synthesize_mel, synthesize_mel_plain)
from challenge_tpu_torch.train.checkpoint import load_weights
from challenge_tpu_torch.train.losses import binary_crossentropy, se_loss

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA's data sheet
FP32_FLOPS = 67e12             # H100 SXM float32 outside the tensor cores
TRAIN_STEPS, VAL_STEPS = 5, 1
SE_STEPS, SE_VAL_STEPS = 3, 1      # each se phase of 5b
SE_TIMED_STEPS = 10                # phase 6's se step
CLI_EPOCHS, CLI_STEPS, CLI_VAL_STEPS = 3, 5, 16
SE_CLI_STEPS = 2                   # phase 7b, per epoch
SR = 16000
CUT_S = 8                      # phase 8's clips, seconds
SCORE_TOL = 1e-5               # phase 8: card vs CPU, times the peak
MIN_GAP = 1e-3                 # phase 8: least logit gap at the threshold
SHARP = 8.0                    # phase 8: logits next to the threshold, after
                               # scaling (sigmoid(-8) = 3.4e-4)


def log(msg: str) -> None:
    print(msg, flush=True)


def sources(seed: int, n_bg: int, bg_len, n_voice: int, voice_len,
            n_noise: int, noise_len):
    """Random [257, T, 4] float32 spectrograms and 30-class voice labels,
    made in bulk from one numpy generator. A length is an int or an
    inclusive (lo, hi) range."""
    rng = np.random.default_rng(seed)

    def lengths(n, spec):
        if isinstance(spec, int):
            return [spec] * n
        return rng.integers(spec[0], spec[1] + 1, n).tolist()

    def specs(n, spec, scale):
        ls = lengths(n, spec)
        block = rng.standard_normal((257, sum(ls), 4), dtype=np.float32)
        block *= scale
        ends = np.cumsum(ls)
        return [block[:, e - t:e] for t, e in zip(ls, ends)]

    return (specs(n_bg, bg_len, 1.0), specs(n_voice, voice_len, 0.5),
            rng.integers(0, 30, n_voice), specs(n_noise, noise_len, 0.3))


def max_abs_diff(args, flat: bool = False) -> float:
    """Max abs difference of a synthesis kernel (the magnitude one, or the
    flat-complex one) and its plain version on ``args``."""
    if flat:
        out, ref = synthesize_flat(*args), synthesize_flat_plain(*args)
    else:
        out = synthesize_magnitude(*args)
        ref = synthesize_magnitude_plain(*args)
    torch.cuda.synchronize()
    if out.shape != ref.shape or out.dtype != ref.dtype:
        raise AssertionError(f'kernel {out.shape} {out.dtype}, plain '
                             f'{ref.shape} {ref.dtype}')
    return float((out.float() - ref.float()).abs().max())


def adversarial_cases(dev):
    """Synthesis arguments that probe the kernel's edges, made with numpy:
    negative shifts and shifts of n_frame and past it, w == 0 slots, clips
    longer than their stated length after short ones in the same slot, a
    lens past the bank's rows, no noise bank, and n_frame not a multiple
    of the kernel's 8-row tile. float32 banks; see :func:`lowp_case`."""
    rng = np.random.default_rng(11)
    f = 4 * 257

    def bank(n, rows, lens=None):
        x = rng.standard_normal((n, rows, f)).astype(np.float32)
        if lens is not None:
            for i, t in enumerate(lens):
                x[i, t:] = 0.0
        return torch.from_numpy(x).to(dev)

    def ints(x):
        return torch.tensor(np.asarray(x), dtype=torch.int32, device=dev)

    def floats(x):
        return torch.tensor(np.asarray(x), dtype=torch.float32, device=dev)

    cases = {}
    nf, b = 61, 3
    vw = rng.uniform(0.1, 1, (b, 4))
    vw[0, 1] = vw[2, 0] = 0.0
    nw = rng.uniform(0.1, 1, (b, 2))
    nw[1, 1] = 0.0
    cases['edges'] = (
        nf, bank(2, 80), ints([0, 1, 1]), ints([0, 7, 19]),
        bank(3, 24), ints(rng.integers(0, 3, (b, 4))),
        ints([[nf, -23, 0, nf - 1], [-24, 100, 5, -3], [2, 2, -200, 60]]),
        floats(vw), bank(2, 12), ints(rng.integers(0, 2, (b, 2))),
        ints([[-11, 0], [nf - 4, 9], [nf, -12]]), floats(nw),
        ints([[24, 30, 10, 24], [1, 24, 24, 7], [24, 3, 24, 24]]), None)
    lens = [96, 20, 50, 96]
    cases['long_then_short'] = (
        64, bank(2, 128), ints([0, 1]), ints([3, 40]),
        bank(4, 96, lens), ints([[0, 1, 2], [3, 2, 1]]),
        ints(rng.integers(-10, 64, (2, 3))),
        floats(rng.uniform(0.5, 1, (2, 3))),
        None, None, None, None, ints(np.asarray(lens)[[[0, 1, 2], [3, 2, 1]]]),
        None)
    return cases


def lowp_case(args, dtype: torch.dtype):
    """A float32 adversarial case with its banks rounded to bfloat16, or
    quantized per item to int8 with the clip scales folded into the
    weights and the background scales passed, as the int8 banks are."""
    (nf, bg, bidx, boff, vb, vidx, vshift, vw, nb, nidx, nshift, nw,
     vlens, nlens) = args

    def quantize(bank):
        peak = bank.abs().amax(dim=(1, 2))
        scale = torch.where(peak > 0, peak / 127.0, torch.ones_like(peak))
        q = torch.clamp(torch.round(bank / scale[:, None, None]), -127, 127)
        return q.to(torch.int8), scale

    if dtype == torch.bfloat16:
        return (nf, bg.to(dtype), bidx, boff, vb.to(dtype), vidx, vshift, vw,
                None if nb is None else nb.to(dtype), nidx, nshift, nw,
                vlens, nlens, None)
    (bg, bs), (vb, vs) = quantize(bg), quantize(vb)
    vw = vw * vs[vidx.long()]
    if nb is not None:
        nb, ns = quantize(nb)
        nw = nw * ns[nidx.long()]
    return (nf, bg, bidx, boff, vb, vidx, vshift, vw, nb, nidx, nshift, nw,
            vlens, nlens, bs[bidx.long()])


def synth_work(d, width: int, dtype: torch.dtype, flat: bool = False):
    """(bytes, flops) that synthesizing the draws ``d`` from banks of
    ``dtype`` needs, counting what this run's data needs: each sample's
    background window, the rows of every active clip (w != 0) that land in
    the window, the slot tables (and int8's background scales) and the
    output written, each once (the magnitude, F/2 columns, or with
    ``flat`` the complex window, F columns); a multiply and an add per
    clip element, int8's background scaling, and 3 operations and a root
    per magnitude."""
    elem = torch.empty((), dtype=dtype).element_size()
    out_elem = torch.empty((), dtype=KERNELS[dtype][1]).element_size()
    n_frame, b = d.n_frame, d.bidx.shape[0]
    rows, table = 0, 2 * b * 4
    for shift, w, lens in ((d.vshift, d.vw, d.vlens),
                           (d.nshift, d.nw, d.nlens)):
        if shift is None:
            continue
        lo = (-shift).clamp(min=0)
        hi = torch.minimum(lens, n_frame - shift)
        rows += int(((hi - lo).clamp(min=0) * (w != 0)).sum())
        table += 4 * shift.numel() * 4
    window = b * n_frame * width
    out = b * n_frame * (width if flat else width // 2)
    nbytes = elem * (window + rows * width) + out_elem * out + table
    flops = 2 * rows * width + (0 if flat else 4 * out)
    if dtype == torch.int8:
        nbytes += 4 * b
        flops += window
    return nbytes, flops


def mel_work(d, width: int, dtype: torch.dtype, band, n_mels: int,
             all_columns: bool = False):
    """(bytes, flops) that the fused mel kernel needs on the draws ``d``:
    each sample's background window and the rows of every active clip
    that land in it, over the band's columns only (re and im of both
    channels at rows f_lo .. f_lo + n_f - 1; ``all_columns`` counts all
    F columns, the dense mel matrix and the full column mask instead), the
    slot tables, the masks, the band and the mel and min/max written,
    each once; a multiply and an add per clip element, 3 operations, a
    root and the mask per magnitude, a multiply and an add per nonzero mel
    product and the time mask per output."""
    elem = torch.empty((), dtype=dtype).element_size()
    n_frame, b = d.n_frame, d.bidx.shape[0]
    cols = width if all_columns else 4 * band.n_f
    rows, table = 0, 2 * b * 4
    for shift, w, lens in ((d.vshift, d.vw, d.vlens),
                           (d.nshift, d.nw, d.nlens)):
        if shift is None:
            continue
        lo = (-shift).clamp(min=0)
        hi = torch.minimum(lens, n_frame - shift)
        rows += int(((hi - lo).clamp(min=0) * (w != 0)).sum())
        table += 4 * shift.numel() * 4
    window = b * n_frame * cols
    nnz = band.row.numel()
    freq = width // 4
    masks = 4 * b * (n_frame + cols // 2)
    band_bytes = (4 * freq * n_mels if all_columns
                  else 4 * (n_mels + 1) + 8 * nnz)
    out = b * n_frame * n_mels * 2
    nbytes = (elem * (window + rows * cols) + table + masks + band_bytes
              + 4 * out + 8 * b)
    products = freq * n_mels if all_columns else nnz
    flops = (2 * rows * cols + 5 * window // 2
             + 2 * b * n_frame * 2 * products + out)
    if dtype == torch.int8:
        nbytes += 4 * b
        flops += window
    return nbytes, flops


def mel_diff(args, melm, tmask, fmask) -> float:
    """Max abs difference of a mel kernel and its plain version on
    ``args``, over the mel and the min/max."""
    kw = dict(melm=melm, tmask=tmask, fmask=fmask)
    (mel, mm), (ref, ref_mm) = (synthesize_mel(*args, **kw),
                                synthesize_mel_plain(*args, **kw))
    torch.cuda.synchronize()
    for a, r in ((mel, ref), (mm, ref_mm)):
        if a.shape != r.shape or a.dtype != r.dtype or a.dtype != \
                torch.float32:
            raise AssertionError(f'kernel {a.shape} {a.dtype}, plain '
                                 f'{r.shape} {r.dtype}')
    return max(float((mel - ref).abs().max()),
               float((mm - ref_mm).abs().max()))


def random_masks(b: int, nf: int, seed: int, dev, zero_sample=None):
    """{0,1} float32 time masks [b, nf] and column masks [b, 514] made with
    numpy; ``zero_sample`` masks every frame of that sample."""
    rng = np.random.default_rng(seed)
    tmask = (rng.random((b, nf)) > 0.2).astype(np.float32)
    fmask = (rng.random((b, 514)) > 0.2).astype(np.float32)
    if zero_sample is not None:
        tmask[zero_sample] = 0.0
    return (torch.from_numpy(tmask).to(dev), torch.from_numpy(fmask).to(dev))


def draws_head(d, n: int):
    """The first ``n`` samples of the draws ``d``."""
    return mixture.Draws(d.n_frame, *(None if x is None else x[:n]
                                      for x in d[1:]))


def mel_checks(dev, banks, main_draws, cases) -> dict:
    """Phase 3d: each mel kernel against its plain version, mel and
    min/max, on the main path's draws with training masks, eval masks
    (all ones) and the filter columns, on batch 1, on a sample whose time
    mask zeroes every frame, and on the adversarial cases (rounded or
    quantized for the low-precision banks)."""
    cfg = Config(model_type='vad', v=9, name='filter')
    fn = FeatureFn(cfg, device=dev, fused_mel=True)
    gen = torch.Generator(device=dev).manual_seed(2)
    errs = {}
    for name, dt in FLAT_DTYPES.items():
        e = dict.fromkeys(('main_train', 'main_eval', 'main_filter',
                           'batch1', 'masked_sample'), 0.0)
        for d in main_draws[:3]:
            args = mixture.synth_args(banks[name], d)
            tmask, fmask = fn.masks(gen)
            fmask = fmask.repeat(1, 2)
            ones = (torch.ones_like(tmask), torch.ones_like(fmask))
            e['main_train'] = max(e['main_train'],
                                  mel_diff(args, fn.melm, tmask, fmask))
            e['main_eval'] = max(e['main_eval'], mel_diff(args, fn.melm,
                                                          *ones))
            e['main_filter'] = max(e['main_filter'], mel_diff(
                args, fn.melm, tmask, fmask * fn.filter_cols))
            one = mixture.synth_args(banks[name], draws_head(d, 1))
            e['batch1'] = max(e['batch1'], mel_diff(one, fn.melm, tmask[:1],
                                                    fmask[:1]))
            zero = tmask.clone()
            zero[3] = 0.0
            e['masked_sample'] = max(e['masked_sample'], mel_diff(
                args, fn.melm, zero, fmask))
            _, mm = synthesize_mel(*args, melm=fn.melm, tmask=zero,
                                   fmask=fmask)
            if mm[3].tolist() != [0.0, 0.0] or not bool((mm[:3, 1] > 0).all()):
                raise AssertionError(f'min/max of a masked sample: {mm}')
        for i, (case, args) in enumerate(cases.items()):
            args = (args + (None,) if dt == torch.float32
                    else lowp_case(args, dt))
            tmask, fmask = random_masks(args[2].shape[0], args[0], i, dev,
                                        zero_sample=0)
            e[case] = mel_diff(args, fn.melm, tmask, fmask)
        errs[MEL_KERNELS[dt]] = e
    return errs


def feature_iter(banks, cfg, training: bool = True, fused_mel: bool = True):
    """Batches of ``FeatureFn(cfg, training, fused_mel=...)`` drawn with a
    ``torch.Generator`` seeded as ``DevicePipeline`` seeds its own."""
    fn = FeatureFn(cfg, training, fused_mel=fused_mel)
    gen = torch.Generator(device=fn.device)
    gen.manual_seed(cfg.seed + (0 if training else 1))
    while True:
        yield fn(gen, banks)


def check_launches(what: str, launches: dict, expected: dict) -> None:
    log(f'{what} launches: {json.dumps(launches)}')
    if launches != expected:
        raise AssertionError(f'{what}: launches {launches}, expected '
                             f'{expected}')


def mel_main_path(banks) -> dict:
    """Phase 5c: vad v9 at full width through ``FeatureFn(fused_mel=True)``
    on float32 banks, ``TrainLoop.fit`` for 5 training steps and 1
    validation step; then v6 and v7 for 2 steps each on the same path, and
    v9 for 2 steps each on bfloat16 and int8 banks. Each run's counts are
    set to 0 just before it and read just after: the mel kernel of the
    banks' dtype must have run once a batch and no other kernel. Returns
    the v9 loop and its iterator for phase 6, and the results."""
    res = {'mel_launches': {}}      # per run, 'v9_float32', ...
    out = None
    for v, name, steps, val_steps in (
            (9, 'float32', TRAIN_STEPS, VAL_STEPS), (6, 'float32', 2, 0),
            (7, 'float32', 2, 0), (9, 'bfloat16', 2, 0), (9, 'int8', 2, 0)):
        cfg = Config(model_type='vad', v=v)
        loop = TrainLoop(get_model(cfg))
        n_params = sum(p.numel() for p in loop.state.module.parameters())
        train_it = feature_iter(banks[name], cfg)
        val_it = feature_iter(banks[name], cfg, training=False)
        cuda.reset_launch_counts()
        hist = loop.fit(train_it, epochs=1, steps_per_epoch=steps,
                        validation_iter=val_it if val_steps else None,
                        validation_steps=val_steps, verbose=0)
        torch.cuda.synchronize()
        kernel = MEL_KERNELS[FLAT_DTYPES[name]]
        launches = dict(cuda.LAUNCHES)
        check_launches(f'vad v{v} fused mel, {name} banks', launches,
                       {kernel: steps + val_steps})
        res['mel_launches'][f'v{v}_{name}'] = launches
        logs = hist[0]
        if not all(math.isfinite(x) for k, x in logs.items() if k != 'time'):
            raise AssertionError(f'vad v{v} {name}: non-finite logs {logs}')
        res[f'v{v}_{name}'] = dict(params=n_params, loss=logs['loss'],
                                   val_loss=logs.get('val_loss'))
        if out is None:
            out = loop, train_it
    return out + (res,)


def chan_main_path(banks) -> dict:
    """Phase 5d: full-width vad v8 with n_chan 3 and 4 through
    ``DevicePipeline``'s complex branch, 2 steps each, the float32
    flat-complex kernel once a batch; and n_chan 1, whose features keep 2
    channels and whose training raises the port's ValueError. Returns the
    n_chan 4 model for phase 7c, and the results."""
    res = {}
    model = None
    for n_chan in (3, 4, 1):
        cfg = Config(model_type='vad', v=8, n_chan=n_chan)
        bundle = get_model(cfg)
        it = iter(DevicePipeline(banks, cfg))
        if n_chan == 1:
            x, _ = next(it)
            if x.shape[-1] != 2 or bundle.input_shape[-1] != 1:
                raise AssertionError(f'n_chan 1: features {tuple(x.shape)}')
            try:
                TrainLoop(bundle).fit(it, epochs=1, steps_per_epoch=1,
                                      verbose=0)
            except ValueError as e:
                if 'mono_chan' not in str(e):
                    raise
                log(f'n_chan 1: 2-channel features; training raises: {e}')
            else:
                raise AssertionError('n_chan 1 training did not raise')
            continue
        loop = TrainLoop(bundle)
        x, _ = next(it)
        if x.shape[-1] != n_chan or bundle.input_shape[-1] != n_chan:
            raise AssertionError(f'n_chan {n_chan}: features '
                                 f'{tuple(x.shape)}')
        cuda.reset_launch_counts()
        hist = loop.fit(it, epochs=1, steps_per_epoch=2, verbose=0)
        torch.cuda.synchronize()
        check_launches(f'vad v8 n_chan {n_chan}', dict(cuda.LAUNCHES),
                       {'synth_flat_f32': 2})
        if not math.isfinite(hist[0]['loss']):
            raise AssertionError(f'n_chan {n_chan}: loss {hist[0]}')
        res[f'chan{n_chan}_loss'] = hist[0]['loss']
        model = bundle.module
    return model, res


def mel_reference_check(dev) -> dict:
    """Phase 4d: the card against the CPU on a small input (batch 4, 80
    mels, 64 frames): the fused-mel kernel's mel and min/max and the labels
    bit for bit on the same draws and masks, the log-mel features within 2
    float32 ulps (the log rounds on each device's own libm); then one
    training-mode forward and loss of full-width vad v6, v7 and v9, the
    card's float32 held to a float64 CPU copy within ``SCORE_TOL`` of each
    output's peak or 10 times the CPU float32's distance (phase 8's
    rule)."""
    cpu = torch.device('cpu')
    cfg = Config(model_type='vad', v=9, n_frame=64, batch_size=4)
    src = sources(3, 3, (20, 90), 6, (10, 40), 3, (8, 20))
    banks = {d: build_banks(*src, n_frame=64, device=d) for d in (cpu, dev)}
    draws = mixture.draw(torch.Generator().manual_seed(5), banks[cpu], 4, 64)
    gdraws = mixture.Draws(*(x.to(dev) if torch.is_tensor(x) else x
                             for x in draws))
    fns = {d: FeatureFn(cfg, device=d, fused_mel=True) for d in (cpu, dev)}
    tmask, fmask = fns[cpu].masks(torch.Generator().manual_seed(6))
    fmask = fmask.repeat(1, 2)
    out = {}
    for d, dr in ((cpu, draws), (dev, gdraws)):
        (mel, mm), y = mixture.synthesize_mel(banks[d], dr, fns[d].melm,
                                              tmask.to(d), fmask.to(d))
        x, y = fns[d].fused_features(mel, mm, y)
        out[d] = [t.cpu() for t in (mel, mm, y, x)]
    for c, g in zip(out[cpu][:3], out[dev][:3]):
        if not torch.equal(c, g):
            raise AssertionError('card vs CPU fused mel: max diff '
                                 f'{float((g - c).abs().max())}')
    xc, xg = out[cpu][3], out[dev][3]
    ulp = torch.nextafter(xc.abs(), torch.tensor(float('inf'))) - xc.abs()
    if not bool(((xg - xc).abs() <= 2 * ulp).all()):
        raise AssertionError('card vs CPU fused log-mel beyond 2 ulps')
    res = {'fused_logmel_bit_equal': bool(torch.equal(xc, xg))}
    gaps = {}
    for v in (6, 7, 9):
        m_c = get_model(Config(model_type='vad', v=v, n_frame=64),
                        device=cpu, seed=v).module
        models = {'cpu': m_c, 'card': copy.deepcopy(m_c).to(dev),
                  'f64': copy.deepcopy(m_c).double()}
        r = {}
        with torch.no_grad():
            for key, m in models.items():
                where = dev if key == 'card' else cpu
                dt = torch.float64 if key == 'f64' else torch.float32
                o = m.train()(xc.to(where, dt))
                r[key] = torch.cat([o.double().cpu().flatten(),
                                    binary_crossentropy(
                                        out[cpu][2].to(where, dt),
                                        o).double().cpu().reshape(1)])
        gaps[f'v{v}'] = {k: float((r[k] - r['f64']).abs().max()
                                  / r['f64'].abs().max())
                         for k in ('cpu', 'card')}
        if gaps[f'v{v}']['card'] > max(SCORE_TOL,
                                       10 * gaps[f'v{v}']['cpu']):
            raise AssertionError(f'card vad v{v} forward beyond the '
                                 f'tolerance: {gaps}')
    log('card vs CPU fused mel, small input: mel, min/max and labels '
        f'equal, log-mel bit-equal {res["fused_logmel_bit_equal"]}; v6, v7, '
        f'v9 forward and loss gaps to float64 over the peak '
        f'{json.dumps(gaps)}')
    return dict(res, version_forward_gaps=gaps)


def chan_cli_chain(d: str, n_chan4_model) -> dict:
    """Phase 7c, in the CLI chain's directory ``d``: ``cli.sj_train`` with
    vad v9, n_chan 3 and int8 banks for 3 epochs of 2 steps, the int8
    flat-complex kernel once a batch; its trio; ``cli.eval --p``; then
    ``evaluate()`` on the same dev set with the n_chan 4 model of phase 5d
    and an n_chan 1 model from ``get_model``."""
    res = {}
    batches = CLI_EPOCHS * (SE_CLI_STEPS + CLI_VAL_STEPS)
    run, res['chan3_launches'], res['chan3_cli_s'] = run_cli(
        ['--model_type', 'vad', '--v', '9', '--n_chan', '3', '--datapath', d,
         '--bank_dtype', 'int8', '--epochs', str(CLI_EPOCHS),
         '--steps_per_epoch', str(SE_CLI_STEPS)], 'synth_flat_int8', batches)
    res['chan3_cli_batches'] = batches
    check_trio(run)
    ers = {'chan3_cli': eval_cli.main(['--name', run, '--p'])}
    for n_chan, module in ((4, n_chan4_model),
                           (1, get_model(Config(model_type='vad', v=9,
                                                n_chan=1)).module)):
        ers[f'chan{n_chan}'] = infer.evaluate(
            Config(model_type='vad', v=8 if n_chan == 4 else 9,
                   n_chan=n_chan), module)
    torch.cuda.synchronize()
    for k, e in ers.items():
        if len(e) != 6 or not all(map(math.isfinite, e)):
            raise AssertionError(f'{k} ERs: {e}')
    log(f'n_chan eval, 6 x 60 s: ERs {json.dumps(ers)}')
    res['chan_ers'] = ers
    return res


def gpu_ms(fn, arg_list, reps: int) -> float:
    """Device milliseconds per call of ``fn`` over ``reps`` calls cycling
    through ``arg_list``. The card first sleeps while the host queues
    every call, so the events time the device work, not Python."""
    fn(*arg_list[0])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    start.record()
    for i in range(reps):
        fn(*arg_list[i % len(arg_list)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def wall_ms(fn, reps: int) -> float:
    """Host milliseconds per call, synchronized at both ends."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def small_reference_check(dev) -> dict:
    """The port on the card against the port on the CPU, on a small
    input: the same draws, masks and weights on both; then int8 synthesis
    on the same draws."""
    cfg = Config(model_type='vad', v=8, n_mels=32, n_frame=64, batch_size=4)
    src = sources(3, 3, (20, 90), 6, (10, 40), 3, (8, 20))
    cpu, gpu = torch.device('cpu'), dev
    banks = {d: build_banks(*src, n_frame=64, device=d) for d in (cpu, gpu)}
    draws = mixture.draw(torch.Generator().manual_seed(5), banks[cpu], 4, 64)
    gdraws = mixture.Draws(*(x.to(gpu) if torch.is_tensor(x) else x
                             for x in draws))
    mag_c, y_c = mixture.synthesize(banks[cpu], draws)
    mag_g, y_g = mixture.synthesize(banks[gpu], gdraws)
    synth_diff = float((mag_g.cpu() - mag_c).abs().max())
    if synth_diff != 0.0 or not torch.equal(y_g.cpu(), y_c):
        raise AssertionError(f'card vs CPU synthesis: max diff {synth_diff}')
    gen = torch.Generator().manual_seed(6)
    tmask = batch_mask_keep(gen, 4, 64, max_mask_size=24, n_mask=6)
    fmask = batch_mask_keep(gen, 4, 257, max_mask_size=16, n_mask=1)
    x_c, l_c = FeatureFn(cfg, device=cpu).features(mag_c, y_c, tmask, fmask)
    x_g, l_g = FeatureFn(cfg, device=gpu).features(
        mag_g, y_g, tmask.to(gpu), fmask.to(gpu))
    feat_err = float((x_g.cpu() - x_c).abs().mean())
    if feat_err > 1e-5 or not torch.equal(l_g.cpu(), l_c):
        raise AssertionError(f'card vs CPU features: mean abs {feat_err}')
    torch.manual_seed(7)
    m_c = VADModel(v=8, base_fsize=8, td_dim=32, n_mels=32).train()
    m_g = VADModel(v=8, base_fsize=8, td_dim=32, n_mels=32).to(gpu).train()
    m_g.load_state_dict(m_c.state_dict())
    with torch.no_grad():
        loss_c = float(binary_crossentropy(l_c, m_c(x_c)))
        loss_g = float(binary_crossentropy(l_g, m_g(x_g)))
    if not math.isclose(loss_g, loss_c, rel_tol=1e-5):
        raise AssertionError(f'card vs CPU loss: {loss_g} vs {loss_c}')
    # 4b: int8 banks, the same draws
    q = {d: build_banks(*src, n_frame=64, flat_dtype='int8', device=d)
         for d in (cpu, gpu)}
    qmag_c, _ = mixture.synthesize(q[cpu], draws)
    qmag_g, _ = mixture.synthesize(q[gpu], gdraws)
    if qmag_g.dtype != torch.bfloat16 or not torch.equal(qmag_g.cpu(),
                                                         qmag_c):
        raise AssertionError('card vs CPU int8 synthesis differ: max diff '
                             f'{float((qmag_g.cpu() - qmag_c).abs().max())}')
    return dict(synth_max_abs=synth_diff, logmel_mean_abs=feat_err,
                loss_gpu=loss_g, loss_cpu=loss_c, int8_synth_max_abs=0.0)


def se_reference_check(dev) -> dict:
    """Phase 4c: the se path on the card against the CPU on a small input
    (batch 2, 32 frames, the full-width cascade). Synthesis, targets and
    features bit for bit in each bank dtype, on the same draws; then one
    training-mode forward of the pretrain cascade and ``se_loss`` on the
    float32 features, the card's float32 held to a float64 CPU copy within
    ``SCORE_TOL`` of each output's peak or 10 times the CPU float32's
    distance (phase 8's rule)."""
    cpu = torch.device('cpu')
    src = sources(4, 3, (40, 90), 6, (10, 40), 3, (8, 20))
    feats = {}
    for name in FLAT_DTYPES:
        banks = {d: build_banks(*src, n_frame=32, flat_dtype=name, device=d)
                 for d in (cpu, dev)}
        draws = mixture.draw(torch.Generator().manual_seed(5), banks[cpu], 2,
                             32)
        gdraws = mixture.Draws(*(x.to(dev) if torch.is_tensor(x) else x
                                 for x in draws))
        out = {}
        for d, dr in ((cpu, draws), (dev, gdraws)):
            spec, targets = mixture.synthesize_se(banks[d], dr)
            x, y = speech_enhancement_preprocess(spec, targets)
            out[d] = [spec, *targets, x, *label_downsample(y, 32)]
        for c, g in zip(out[cpu], out[dev]):
            if c.dtype != g.dtype or not torch.equal(g.cpu(), c):
                raise AssertionError(f'card vs CPU se synthesis ({name}): '
                                     f'max diff '
                                     f'{float((g.cpu() - c).abs().max())}')
        if name == 'float32':
            feats = out
    m_c = SECascade(pretrain=True)
    m_c.reset_parameters(torch.Generator().manual_seed(8))
    models = {'cpu': m_c, 'card': copy.deepcopy(m_c).to(dev),
              'f64': copy.deepcopy(m_c).double()}
    res = {}
    with torch.no_grad():
        for key, m in models.items():
            where = cpu if key != 'card' else dev
            dt = torch.float64 if key == 'f64' else torch.float32
            x = feats[where][4].to(dt)
            y = tuple(t.to(dt) for t in feats[where][5:])
            outs = m.train()(x)
            res[key] = [o.double().cpu() for o in outs] + [
                se_loss(y, outs)[0].double().cpu().reshape(1)]
    gaps = {}
    for key in ('cpu', 'card'):
        gaps[key] = max(float((a - b).abs().max() / b.abs().max())
                        for a, b in zip(res[key], res['f64']))
    log(f'card vs CPU se, small input: synthesis, targets and features '
        f'equal; forward and loss gap to float64 over the peak '
        f'{json.dumps(gaps)}')
    if gaps['card'] > max(SCORE_TOL, 10 * gaps['cpu']):
        raise AssertionError('card se forward beyond the tolerance')
    return dict(se_forward_gap_cpu=gaps['cpu'],
                se_forward_gap_card=gaps['card'])


def se_main_path(banks) -> dict:
    """Phase 5b: se v9 at full width, pretrain then finetune from its
    weights, through ``get_model``, ``DevicePipeline`` and
    ``TrainLoop.fit``, each run's launch counts set to 0 just before it
    and read just after. Returns the pretrain loop and its iterator for
    phase 6, and the results."""
    res = {'se_launches': {}, 'se_batches': 0}
    weights, out = None, None
    for pretrain, frozen in ((True, 'vad.'), (False, 'se.')):
        cfg = Config(model_type='se', v=9, pretrain=pretrain)
        loop = TrainLoop(get_model(cfg))
        if weights is not None:
            loop.set_weights(weights)
        if pretrain:
            res['se_params'] = sum(p.numel()
                                   for p in loop.state.module.parameters())
        before = loop.get_weights()
        train_it = iter(DevicePipeline(banks, cfg))
        val_it = iter(DevicePipeline(banks, cfg, training=False))
        cuda.reset_launch_counts()
        hist = loop.fit(train_it, epochs=1, steps_per_epoch=SE_STEPS,
                        validation_iter=val_it, validation_steps=SE_VAL_STEPS)
        torch.cuda.synchronize()
        launches = dict(cuda.LAUNCHES)
        phase = 'pretrain' if pretrain else 'finetune'
        log(f'se {phase} launches: {json.dumps(launches)}')
        n = SE_STEPS + SE_VAL_STEPS
        if launches != {'synth_flat_f32': 3 * n}:
            raise AssertionError(f'se {phase}: {launches} for {n} batches')
        for k, v in launches.items():
            res['se_launches'][k] = res['se_launches'].get(k, 0) + v
        res['se_batches'] += n
        logs = hist[0]
        res[f'se_{phase}_logs'] = logs
        names = ('loss', 'class_loss', 'speech_loss', 'noise_loss', 'val_loss',
                 'val_class_loss', 'val_speech_loss', 'val_class_er')
        if not all(math.isfinite(logs[k]) for k in names):
            raise AssertionError(f'se {phase}: non-finite logs {logs}')
        weights = loop.get_weights()
        for k, v in weights.items():
            if torch.equal(v, before[k]) != k.startswith(frozen):
                raise AssertionError(f'se {phase}: {k} '
                                     + ('moved' if k.startswith(frozen)
                                        else 'did not move'))
        if pretrain:
            out = loop, train_it
    return out + (res,)


def model_step_ms(benchmark: bool, reps: int = 10) -> float:
    """vad v8's training step at full width on one fixed batch, with
    ``cudnn.benchmark`` as given, in this process. cuDNN keeps the
    algorithms it has chosen for a shape for the life of the process and
    consults them even with the flag off, so each setting needs a fresh
    process."""
    cfg = Config(model_type='vad', v=8)
    banks = build_banks(*sources(0, 4, 600, 16, (40, 130), 8, (20, 100)),
                        n_frame=cfg.n_frame)
    batch = next(iter(DevicePipeline(banks, cfg)))
    loop = TrainLoop(get_model(cfg))
    # after the entry points, which turn it on
    torch.backends.cudnn.benchmark = benchmark
    for _ in range(3):
        loop.train_step(loop.state, batch)
    return wall_ms(lambda: loop.train_step(loop.state, batch), reps)


def cudnn_ab() -> dict:
    """The model step with cuDNN's per-shape algorithm timing off and on,
    each in a fresh process, in the order off, on, on, off."""
    res = {'off': [], 'on': []}
    for flag in ('off', 'on', 'on', 'off'):
        out = subprocess.run(
            [sys.executable, __file__, '--model-step', flag],
            capture_output=True, text=True, check=True, timeout=300).stdout
        res[flag].append(json.loads(out.strip().splitlines()[-1])['ms'])
    return res


def profile_steps(loop, it, steps: int, label: str = 'PROFILE') -> None:
    """torch.profiler over ``steps`` training steps: device time by kernel
    and the card's busy share of the wall time, printed on a ``label``
    line."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        loop.run_epoch(it, steps, training=True)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    events_ = prof.key_averages()
    attr = ('self_device_time_total' if hasattr(events_[0],
                                                'self_device_time_total')
            else 'self_cuda_time_total')
    device = [e for e in events_
              if e.device_type == torch.autograd.DeviceType.CUDA]
    # the optimizer's annotated range spans its kernels and the gaps
    # between them; the rest are kernels
    opt_us = sum(getattr(e, attr) for e in device
                 if e.key.startswith('Optimizer.step'))
    rows = sorted(((getattr(e, attr), e.key, e.count) for e in device
                   if getattr(e, attr) > 0
                   and not e.key.startswith('Optimizer.step')), reverse=True)
    busy_us = sum(r[0] for r in rows)
    log(f'profile: {steps} steps, wall {wall * 1e3:.3f} ms, kernel time '
        f'{busy_us / 1e3:.3f} ms, optimizer range {opt_us / 1e3:.3f} ms')
    for us, key, count in rows[:25]:
        log(f'  {us / 1e3:10.3f} ms  {count:6d}x  {key[:90]}')
    log(label + ' ' + json.dumps({
        'steps': steps, 'wall_ms': wall * 1e3, 'kernel_ms': busy_us / 1e3,
        'optimizer_range_ms': opt_us / 1e3,
        'synth_ms': sum(r[0] for r in rows if 'synth_' in r[1]) / 1e3}))


def write_dev_set(d: str, n_clips: int = 6, seconds: float = 60.0,
                  seed: int = 0) -> dict:
    """``n_clips`` two-channel 16 kHz int16 WAVs of noise with tone events
    of three classes (300, 800 and 1,500 Hz, 0.8-2 s each), and the
    ``sample_answer.json`` that lists the events. Returns the answers."""
    rng = np.random.default_rng(seed)
    answers = {}
    for i in range(n_clips):
        n = int(seconds * SR)
        sig = 0.05 * rng.standard_normal((n, 2))
        evs, t = [], float(rng.uniform(0.5, 2.0))
        while t + 2.5 < seconds:
            cls, dur = int(rng.integers(0, 3)), float(rng.uniform(0.8, 2.0))
            s0, s1 = int(t * SR), int((t + dur) * SR)
            tone = np.sin(2 * np.pi * (300, 800, 1500)[cls]
                          * np.arange(s1 - s0) / SR)
            sig[s0:s1] += 0.2 * tone[:, None]
            evs.append([cls, round(t, 3), round(t + dur, 3)])
            t += dur + float(rng.uniform(1.0, 4.0))
        write_wav(os.path.join(d, f'dev{i:02d}.wav'),
                  (np.clip(sig, -1, 1) * 32767).astype('<i2'))
        answers[f'dev{i:02d}'] = evs
    with open(os.path.join(d, 'sample_answer.json'), 'w') as f:
        json.dump({'task2_answer': answers}, f)
    return answers


def write_wav(path: str, pcm) -> None:
    """int16 [n, chan] -> 16-bit PCM WAV at 16 kHz."""
    with wave.open(path, 'wb') as f:
        f.setnchannels(pcm.shape[1])
        f.setsampwidth(2)
        f.setframerate(SR)
        f.writeframes(pcm.tobytes())


def write_spec_sets(d: str, train_src, test_src) -> None:
    """The spec sets as pickles (labels as .npy) under sj_train's default
    file names; the noises are shared by both sets, as in the CLI."""
    cfg = Config()
    bgs, voices, labels, noises = train_src
    tbgs, tvoices, tlabels, _ = test_src
    for name, obj in ((cfg.background_sounds, bgs), (cfg.voices, voices),
                      (cfg.noises, noises),
                      (cfg.test_background_sounds, tbgs),
                      (cfg.test_voices, tvoices)):
        with open(os.path.join(d, name), 'wb') as f:
            pickle.dump(list(obj), f, protocol=pickle.HIGHEST_PROTOCOL)
    np.save(os.path.join(d, cfg.labels), labels)
    np.save(os.path.join(d, cfg.test_labels), tlabels)


def run_cli(argv, kernel: str, batches: int, per_batch: int = 1):
    """``cli.sj_train.main(argv)`` with the launch counts set to 0 just
    before and read just after; ``kernel`` must have launched
    ``per_batch`` times a batch. Returns (run name, counts, wall
    seconds)."""
    cuda.reset_launch_counts()
    t0 = time.perf_counter()
    run = sj_train.main(argv)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = dict(cuda.LAUNCHES)
    log(f'cli {kernel}: {json.dumps(counts)} in {secs:.3f} s')
    if counts.get(kernel, 0) != per_batch * batches:
        raise AssertionError(f'{kernel} ran {counts.get(kernel, 0)} times '
                             f'for {batches} batches')
    return run, counts, secs


def check_trio(run: str) -> None:
    for suffix in ('.h5', '_SWA.h5', '_sample.h5'):
        if not os.path.exists(run + suffix):
            raise AssertionError(f'missing checkpoint {run}{suffix}')


def se_cli_chain(d: str) -> dict:
    """Phase 7b, in the CLI chain's directory ``d``: se v9 pretrain on
    int8 banks, finetune on bfloat16 banks from its checkpoint, then the
    eval CLI on the finetuned ``_SWA.h5``."""
    res = {}
    base = ['--model_type', 'se', '--v', '9', '--n_chan', '2',
            '--datapath', d, '--epochs', str(CLI_EPOCHS),
            '--steps_per_epoch', str(SE_CLI_STEPS)]
    batches = CLI_EPOCHS * (SE_CLI_STEPS + CLI_VAL_STEPS)
    pre, res['se_int8_launches'], res['se_int8_cli_s'] = run_cli(
        base + ['--bank_dtype', 'int8', '--pretrain', 'True'],
        'synth_flat_int8', batches, per_batch=3)
    check_trio(pre)
    # the finetune run loads {run}.h5 under its own name, which has no
    # '_weight' (sj_train.py:467-469); the reference's bool flag reads any
    # value of --pretrain as True, so finetuning leaves it out
    run = pre[:-len('_weight')]
    shutil.copy(pre + '.h5', run + '.h5')
    got, res['se_bf16_launches'], res['se_bf16_cli_s'] = run_cli(
        base + ['--bank_dtype', 'bfloat16'], 'synth_flat_bf16', batches,
        per_batch=3)
    if got != run:
        raise AssertionError(f'finetune run {got}, expected {run}')
    check_trio(run)
    pre_w, ft_w = load_weights(pre + '.h5'), load_weights(run + '.h5')
    moved = {k for k in pre_w if not torch.equal(pre_w[k], ft_w[k])}
    if not moved or any(k.startswith('se.') for k in moved):
        raise AssertionError('finetune must train the head and leave the '
                             'U-Net bit-identical')
    res['se_cli_batches'] = batches
    t0 = time.perf_counter()
    ers = eval_cli.main(['--name', run + '_SWA', '--p'])
    torch.cuda.synchronize()
    res['se_eval_s'] = time.perf_counter() - t0
    if len(ers) != 6 or not all(map(math.isfinite, ers)):
        raise AssertionError(f'se eval CLI ERs: {ers}')
    res['se_ers'] = ers
    log(f'se eval CLI, 6 x 60 s: ERs {ers} in {res["se_eval_s"]:.3f} s')
    return res


def cli_chain(dev, train_src, test_src, chan4_model) -> dict:
    """Phases 7, 8, 7b and 7c, in a temporary directory that is removed
    after."""
    res = {}
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory(prefix='chip_smoke_') as d:
        os.chdir(d)
        try:
            write_spec_sets(d, train_src, test_src)
            answers = write_dev_set(d)
            base = ['--model_type', 'vad', '--v', '8', '--n_chan', '2',
                    '--datapath', d]
            batches = CLI_EPOCHS * (CLI_STEPS + CLI_VAL_STEPS)
            run, counts, res['int8_cli_s'] = run_cli(
                base + ['--bank_dtype', 'int8', '--epochs', str(CLI_EPOCHS),
                        '--steps_per_epoch', str(CLI_STEPS)],
                'synth_mag_int8', batches)
            res['int8_launches'], res['int8_batches'] = counts, batches
            check_trio(run)
            with open(run + '.csv') as f:
                rows = f.read().strip().splitlines()
            if len(rows) != 1 + CLI_EPOCHS:
                raise AssertionError(f'{run}.csv has {len(rows)} lines')
            t0 = time.perf_counter()
            ers = eval_cli.main(['--name', run, '--p'])
            torch.cuda.synchronize()
            res['eval_s'] = time.perf_counter() - t0
            if len(ers) != 6 or not all(map(math.isfinite, ers)):
                raise AssertionError(f'eval CLI ERs: {ers}')
            res['ers'] = ers
            log(f'eval CLI, 6 x 60 s: ERs {ers} in {res["eval_s"]:.3f} s')
            _, counts, res['bf16_cli_s'] = run_cli(
                base + ['--bank_dtype', 'bfloat16', '--name', 'bf16',
                        '--epochs', '1', '--steps_per_epoch',
                        str(CLI_STEPS)],
                'synth_mag_bf16', CLI_STEPS + CLI_VAL_STEPS)
            res['bf16_launches'] = counts
            res['bf16_batches'] = CLI_STEPS + CLI_VAL_STEPS
            res.update(card_vs_cpu_eval(dev, run, answers))
            res.update(se_cli_chain(d))
            res.update(chan_cli_chain(d, chan4_model))
        finally:
            os.chdir(cwd)
    return res


def clip_windows(cfg, module, paths):
    """The model inputs (log-mel windows) of ``paths``, concatenated."""
    windows = []
    hook = module.register_forward_pre_hook(
        lambda mod, args: windows.append(args[0]))
    for path in paths:
        infer.clip_scores(cfg, module, path)
    hook.remove()
    return torch.cat(windows)


def event_bias_shift(z):
    """Per class, the output bias shift that puts the 0.5 threshold in the
    middle of the widest gap between the sorted logits ``z [n, C]`` with
    at least one and at most half of them above it, so that no logit lies
    near it, and that gap's width. A class whose widest such gap is under
    ``MIN_GAP`` (its logits hardly vary) is shifted 10 below its least
    logit instead, and predicts no event."""
    zs = torch.sort(z, dim=0).values
    n = zs.shape[0]
    gaps = zs[n // 2 + 1:] - zs[n // 2:-1]
    k = gaps.argmax(dim=0) + n // 2
    cols = torch.arange(zs.shape[1])
    mid = (zs[k, cols] + zs[k + 1, cols]) / 2
    width = gaps.amax(dim=0)
    return torch.where(width >= MIN_GAP, -mid, -zs[-1] - 10.0), width


def card_vs_cpu_eval(dev, run: str, answers: dict) -> dict:
    """Phase 8: ``run``'s _SWA.h5 on the card and on the CPU over the first
    2 dev clips cut to ``CUT_S`` seconds, made to predict events first.

    After a few steps the BN running statistics are still near their
    initial 0 and 1, so the eval-mode outputs hardly vary and predict no
    event. The statistics are therefore set to those of the whole dev
    set's windows (one training-mode forward on the card with momentum 0),
    and the output bias is shifted per class (:func:`event_bias_shift`).
    The CPU's model and a float64 copy of it get the same weights.

    Held, on the scores: the card's spectrogram against the CPU's within
    ``SCORE_TOL`` of the peak; the card's scores from the CPU's
    spectrogram against the float64 scores within ``SCORE_TOL`` of the
    peak, or within 10 times the distance of the CPU's float32 scores (a
    model whose outputs vary with its input amplifies float32 rounding,
    and the card's convolution algorithms round otherwise than the
    CPU's). Then each class's logits are scaled until those next to the
    threshold lie ``SHARP`` from it, so that every smoothed score lies at
    least 1/62 from 0.5, and held on the grids: end to end they may
    differ only at frames within ``SCORE_TOL`` of 0.5, must hold events
    and silence, and give identical ERs against the answers inside each
    clip."""
    cfg = Config(model_type='vad', v=8)
    paths = []
    for i in range(2):
        with wave.open(f'dev{i:02d}.wav', 'rb') as f:
            pcm = np.frombuffer(f.readframes(CUT_S * SR),
                                '<i2').reshape(-1, 2)
        paths.append(f'cut{i:02d}.wav')
        write_wav(paths[-1], pcm)
    card, cpu = (get_model(cfg, device=where).module
                 for where in (dev, torch.device('cpu')))
    card.load_state_dict(load_weights(run + '_SWA.h5'))
    x = clip_windows(cfg, card, [f'{name}.wav' for name in sorted(answers)])
    bns = [m for m in card.modules() if isinstance(m, BatchNorm)]
    momenta = [m.momentum for m in bns]
    logits = []
    with torch.no_grad():
        for m in bns:
            m.momentum = 0.0
        card.train()(x)
        for m, momentum in zip(bns, momenta):
            m.momentum = momentum
        last = card.fcs[-1].dense
        hook = last.register_forward_hook(
            lambda mod, args, out: logits.append(out))
        card.eval()(clip_windows(cfg, card, paths))
        hook.remove()
        shift, widths = event_bias_shift(
            logits[-1].reshape(-1, last.out_features).cpu())
        last.bias += shift.to(dev)
    cpu.load_state_dict(card.state_dict())
    ref = copy.deepcopy(cpu).double()

    gap = dict.fromkeys(('spec', 'cpu_vs_f64', 'card_vs_f64', 'card_vs_cpu',
                         'end_to_end'), 0.0)
    specs = []
    for path in paths:
        spec = {'cpu': load_wav(path, device='cpu'),
                'card': load_wav(path, device=dev).cpu()}
        specs.append(spec)
        scores = {
            'f64': infer.spec_to_scores(cfg, ref, spec['cpu']),
            'cpu': infer.spec_to_scores(cfg, cpu, spec['cpu']),
            'card': infer.spec_to_scores(cfg, card,
                                         spec['cpu'].to(dev)).cpu(),
            'card_e2e': infer.spec_to_scores(cfg, card,
                                             spec['card'].to(dev)).cpu()}
        peak = float(scores['f64'].abs().max())
        for key, a, b in (
                ('spec', spec['card'], spec['cpu']),
                ('cpu_vs_f64', scores['cpu'], scores['f64']),
                ('card_vs_f64', scores['card'], scores['f64']),
                ('card_vs_cpu', scores['card'], scores['cpu']),
                ('end_to_end', scores['card_e2e'], scores['cpu'])):
            ref_peak = float(b.abs().max()) if key == 'spec' else peak
            gap[key] = max(gap[key],
                           float((a - b).abs().max()) / ref_peak)
    log(f'card vs CPU eval, 2 clips of {CUT_S} s: logit gaps at the '
        f'threshold {widths.tolist()}, max abs gaps over the peak '
        f'{json.dumps(gap)}')
    if gap['spec'] > SCORE_TOL:
        raise AssertionError('card vs CPU spectrogram beyond the tolerance')
    if gap['card_vs_f64'] > max(SCORE_TOL, 10 * gap['cpu_vs_f64']):
        raise AssertionError('card scores beyond the tolerance')

    scale = torch.where(widths >= MIN_GAP, 2 * SHARP / widths, 1.0)
    with torch.no_grad():
        for m in (card, cpu):
            m.fcs[-1].dense.weight *= scale.to(m.td.weight.device)[:, None]
            m.fcs[-1].dense.bias *= scale.to(m.td.weight.device)
    to_metric = events.output_to_metric(infer.HOP, SR)
    borderline, positive, nearest = 0, [], 0.5
    ers = {'card': [], 'cpu': []}
    for i, spec in enumerate(specs):
        scores = {'cpu': infer.spec_to_scores(cfg, cpu, spec['cpu']),
                  'card': infer.spec_to_scores(cfg, card,
                                               spec['card'].to(dev)).cpu()}
        grids = {k: (v >= 0.5).float().numpy() for k, v in scores.items()}
        dist = np.abs(scores['cpu'].numpy() - 0.5)
        differ = grids['card'] != grids['cpu']
        if (differ & (dist > SCORE_TOL)).any():
            raise AssertionError(f'clip {i}: card and CPU grids differ away '
                                 'from the 0.5 threshold')
        borderline += int(differ.sum())
        nearest = min(nearest, float(dist.min()))
        positive.append(float(grids['cpu'].mean()))
        gt = np.asarray([[c, t0, min(t1, CUT_S)] for c, t0, t1
                         in answers[f'dev{i:02d}'] if t0 < CUT_S])
        for k, g in grids.items():
            ers[k].append(events.get_er(gt, to_metric(
                *events.get_start_end_frame(g))))
    log(f'card vs CPU grids: positive share {positive}, nearest score to '
        f'0.5 at {nearest}, {borderline} frames differ, ERs {ers}')
    if not 0.0 < np.mean(positive) < 1.0:
        raise AssertionError(f'positive grid share per clip: {positive}')
    if ers['card'] != ers['cpu']:
        raise AssertionError(f'card vs CPU ERs: {ers}')
    for path in paths:              # the dev set is scored again in 7b
        os.remove(path)
    return dict(cut_ers=ers['card'], cut_max_rel_gap=gap,
                cut_positive_share=positive, cut_nearest_to_half=nearest,
                borderline_frames=borderline)


def main(argv) -> int:
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 1
    if '--model-step' in argv:
        flag = argv[argv.index('--model-step') + 1]
        log(json.dumps({'ms': model_step_ms(flag == 'on')}))
        return 0
    dev = torch.device('cuda', 0)
    log(f'torch {torch.__version__}, CUDA {torch.version.cuda}, '
        f'{torch.cuda.get_device_name(0)}')

    # 1. build
    secs = cuda.build(['synth', 'synth_mel'], verbose=True)
    log(f'build: {secs:.3f} s')

    # 2. banks at a realistic size, in the three bank dtypes
    t0 = time.perf_counter()
    src = sources(0, 32, 1875, 512, (40, 130), 128, (20, 100))
    banks = {name: build_banks(*src, n_frame=512, flat_dtype=name)
             for name in FLAT_DTYPES}
    torch.cuda.synchronize()
    for name, bk in banks.items():
        nbytes = sum(t.numel() * t.element_size() for b in
                     (bk.backgrounds, bk.voices, bk.noises)
                     for t in (b.flat, b.lens, b.pos_mask, b.flat_scale)
                     if t is not None)
        log(f'banks {name}: {nbytes / 2**30:.3f} GiB on the card')
    log(f'banks built in {time.perf_counter() - t0:.3f} s')

    # 3, 3b. each kernel against its plain version
    cfg = Config(model_type='vad', v=8)
    gen = torch.Generator(device=dev).manual_seed(1)
    main_draws = [mixture.draw(gen, banks['float32'], cfg.batch_size,
                               cfg.n_frame, max_voices=cfg.max_voices,
                               max_noises=cfg.max_noises, snr=cfg.snr)
                  for _ in range(16)]
    cases = adversarial_cases(dev)
    errs = {}
    for name, dt in FLAT_DTYPES.items():
        e = {'main_path': max(max_abs_diff(mixture.synth_args(banks[name], d))
                              for d in main_draws[:4])}
        for case, args in cases.items():
            e[case] = max_abs_diff(args if dt == torch.float32
                                   else lowp_case(args, dt))
        errs[KERNELS[dt][0]] = e
    # 3c. the flat-complex kernels: the same draws and cases, and the se
    # triple's other two calls, and its voices-only call with every voice
    # slot inactive (nothing but the zero background)
    for name, dt in FLAT_DTYPES.items():
        e = {'main_path': max(max_abs_diff(mixture.synth_args(banks[name], d),
                                           flat=True)
                              for d in main_draws[:4])}
        for case, args in cases.items():
            e[case] = max_abs_diff(args if dt == torch.float32
                                   else lowp_case(args, dt), flat=True)
        _, only_noise, only_voice = mixture.se_synth_args(banks[name],
                                                          main_draws[0])
        no_voice = (only_voice[:7] + (torch.zeros_like(only_voice[7]),)
                    + only_voice[8:])
        for case, args in (('se_only_noise', only_noise),
                           ('se_only_voice', only_voice),
                           ('se_no_voice', no_voice)):
            e[case] = max_abs_diff(args, flat=True)
        errs[FLAT_KERNELS[dt]] = e
    # 3d. the fused mel kernels
    errs.update(mel_checks(dev, banks, main_draws, cases))
    log('kernel vs plain, max abs diff: ' + json.dumps(errs))
    if any(v != 0.0 for e in errs.values() for v in e.values()):
        raise AssertionError('a synthesis kernel disagrees with its plain '
                             'version')

    # 4, 4b, 4c. the card against the CPU on a small input
    log('card vs CPU, small input: ' + json.dumps(small_reference_check(dev)))
    se_ref = se_reference_check(dev)
    mel_ref = mel_reference_check(dev)

    # 5. the main path
    f32_kernel = KERNELS[torch.float32][0]
    loop = TrainLoop(get_model(cfg))
    train_it = iter(DevicePipeline(banks['float32'], cfg))
    val_it = iter(DevicePipeline(banks['float32'], cfg, training=False))
    cuda.reset_launch_counts()
    hist = loop.fit(train_it, epochs=1, steps_per_epoch=TRAIN_STEPS,
                    validation_iter=val_it, validation_steps=VAL_STEPS)
    torch.cuda.synchronize()
    launches = dict(cuda.LAUNCHES)
    logs = hist[0]
    log('main path launches: ' + json.dumps(launches))
    if launches.get(f32_kernel, 0) != TRAIN_STEPS + VAL_STEPS:
        raise AssertionError(f'{f32_kernel} ran '
                             f'{launches.get(f32_kernel, 0)} times for '
                             f'{TRAIN_STEPS + VAL_STEPS} batches')
    if not all(math.isfinite(logs[k]) for k in ('loss', 'val_loss')):
        raise AssertionError(f'non-finite losses: {logs}')

    # 5b. the se slice's main path
    se_loop, se_train_it, se = se_main_path(banks['float32'])

    # 5c. this slice's main path: vad v9 through the fused mel kernel; 5d.
    # the channel maps through the flat-complex kernel
    v9_loop, v9_train_it, mel = mel_main_path(banks)
    chan4_model, chan = chan_main_path(banks['float32'])

    # 6. times: each kernel on the main path's draws (the flat-complex
    # ones on the se full mix, the first of its three calls)
    timing = {}
    for flat, fn, plain, names in (
            (False, synthesize_magnitude, synthesize_magnitude_plain,
             {dt: KERNELS[dt][0] for dt in KERNELS}),
            (True, synthesize_flat, synthesize_flat_plain, FLAT_KERNELS)):
        for name, dt in FLAT_DTYPES.items():
            args = [mixture.synth_args(banks[name], d) for d in main_draws]
            kernel_ms, plain_ms = [], []
            for which in ('plain', 'kernel', 'kernel', 'plain'):
                if which == 'kernel':
                    kernel_ms.append(gpu_ms(fn, args, 64))
                else:
                    plain_ms.append(gpu_ms(plain, args, 16))
            work = [synth_work(d, banks[name].backgrounds.flat.shape[-1], dt,
                               flat) for d in main_draws]
            nbytes = sum(w[0] for w in work) / len(work)
            flops = sum(w[1] for w in work) / len(work)
            bound_ms = max(nbytes / HBM_BYTES_PER_S,
                           flops / FP32_FLOPS) * 1e3
            timing[names[dt]] = dict(
                ms=sum(kernel_ms) / len(kernel_ms),
                plain_ms=sum(plain_ms) / len(plain_ms), bound_ms=bound_ms,
                bound_by=('bytes' if nbytes / HBM_BYTES_PER_S
                          >= flops / FP32_FLOPS else 'operations'))
            log(f'{names[dt]}: kernel {kernel_ms} ms, plain {plain_ms} ms, '
                f'{nbytes / 1e6:.3f} MB and {flops / 1e9:.4f} GFLOP per '
                f'call, bound {bound_ms * 1e3:.3f} us')
    # the mel kernels on the main path's draws with training masks; bounds
    # over the band's columns and, beside them, over all columns
    mel_fn = FeatureFn(Config(model_type='vad', v=9), device=dev,
                       fused_mel=True)
    band = mel_fn.band
    mask_gen = torch.Generator(device=dev).manual_seed(3)
    masks = []
    for _ in main_draws:
        tmask, fmask = mel_fn.masks(mask_gen)
        masks.append((mel_fn.melm, tmask, fmask.repeat(1, 2)))
    for name, dt in FLAT_DTYPES.items():
        args = [mixture.synth_args(banks[name], d) + m
                for d, m in zip(main_draws, masks)]
        kernel_ms, plain_ms = [], []
        for which in ('plain', 'kernel', 'kernel', 'plain'):
            fn = synthesize_mel if which == 'kernel' else synthesize_mel_plain
            run = (lambda fn: lambda *a: fn(*a[:-3], melm=a[-3], tmask=a[-2],
                                            fmask=a[-1], band=band))(fn)
            if which == 'kernel':
                kernel_ms.append(gpu_ms(run, args, 64))
            else:
                plain_ms.append(gpu_ms(run, args, 16))
        width = banks[name].backgrounds.flat.shape[-1]
        work = {cols: [mel_work(d, width, dt, band, 80, cols == 'all')
                       for d in main_draws] for cols in ('band', 'all')}
        nbytes = {k: sum(w[0] for w in v) / len(v) for k, v in work.items()}
        flops = sum(w[1] for w in work['band']) / len(work['band'])
        bound_ms = max(nbytes['band'] / HBM_BYTES_PER_S,
                       flops / FP32_FLOPS) * 1e3
        timing[MEL_KERNELS[dt]] = dict(
            ms=sum(kernel_ms) / len(kernel_ms),
            plain_ms=sum(plain_ms) / len(plain_ms), bound_ms=bound_ms,
            bound_by=('bytes' if nbytes['band'] / HBM_BYTES_PER_S
                      >= flops / FP32_FLOPS else 'operations'),
            bound_ms_all_columns=nbytes['all'] / HBM_BYTES_PER_S * 1e3)
        log(f'{MEL_KERNELS[dt]}: kernel {kernel_ms} ms, plain {plain_ms} ms, '
            f'{nbytes["band"] / 1e6:.3f} MB over the band '
            f'({nbytes["all"] / 1e6:.3f} MB over all columns) and '
            f'{flops / 1e9:.4f} GFLOP per call, bound '
            f'{bound_ms * 1e3:.3f} us')

    batch = next(train_it)
    step_ms = wall_ms(lambda: loop.run_epoch(train_it, 20, training=True),
                      1) / 20
    pipe_ms = wall_ms(lambda: next(train_it), 20)
    model_ms = wall_ms(lambda: loop.train_step(loop.state, batch), 20)
    if '--profile' in argv:
        profile_steps(loop, train_it, 10)
    if '--cudnn-ab' in argv:
        log('CUDNN model_step_ms, fresh process each: '
            + json.dumps(cudnn_ab()))
    del loop, train_it, val_it

    # the se v9 step (pretrain, float32 banks), timed as vad's
    se_batch = next(se_train_it)
    se['se_step_ms'] = wall_ms(lambda: se_loop.run_epoch(
        se_train_it, SE_TIMED_STEPS, training=True), 1) / SE_TIMED_STEPS
    se['se_pipeline_ms'] = wall_ms(lambda: next(se_train_it), 10)
    se['se_model_step_ms'] = wall_ms(
        lambda: se_loop.train_step(se_loop.state, se_batch), 5)
    se['se_peak_gib'] = torch.cuda.max_memory_allocated() / 2**30
    if '--profile' in argv:
        profile_steps(se_loop, se_train_it, 5, 'SE_PROFILE')
    del se_loop, se_train_it, se_batch

    # the v9 fused-mel step, timed as vad's; then the batch pipeline
    # through kernel B4 and through B1 plus the matmul mel, in turns
    v9_loop.run_epoch(v9_train_it, 3, training=True)
    mel['v9_step_ms'] = wall_ms(lambda: v9_loop.run_epoch(
        v9_train_it, 20, training=True), 1) / 20
    v9_batch = next(v9_train_it)
    mel['v9_model_step_ms'] = wall_ms(
        lambda: v9_loop.train_step(v9_loop.state, v9_batch), 20)
    if '--profile' in argv:
        profile_steps(v9_loop, v9_train_it, 10, 'V9_PROFILE')
    v9_cfg = Config(model_type='vad', v=9)
    pipes = {k: feature_iter(banks['float32'], v9_cfg, fused_mel=k)
             for k in (False, True)}
    for it in pipes.values():
        next(it)
    mel['pipeline_ms'], mel['fused_mel_pipeline_ms'] = [], []
    for fused in (False, True, True, False):
        mel['fused_mel_pipeline_ms' if fused else 'pipeline_ms'].append(
            wall_ms(lambda: next(pipes[fused]), 20))
    del v9_loop, v9_train_it, v9_batch, pipes

    # the training step in banks mode, as the CLI runs it, and the batch
    # pipeline alone, with float32 and int8 banks in turns
    bank_step_ms = {'float32': [], 'int8': []}
    bank_pipe_ms = {'float32': [], 'int8': []}
    bank_loops = {name: TrainLoop(get_model(cfg.replace(bank_dtype=name)),
                                  banks=banks[name]) for name in bank_step_ms}
    for bl in bank_loops.values():
        bl.run_epoch(None, 3, training=True, epoch=99)
    for name in ('float32', 'int8', 'int8', 'float32'):
        bl = bank_loops[name]
        bank_step_ms[name].append(wall_ms(
            lambda: bl.run_epoch(None, 20, training=True, epoch=0), 1) / 20)
        it = iter(DevicePipeline(banks[name], cfg))
        bank_pipe_ms[name].append(wall_ms(lambda: next(it), 20))
    del bank_loops

    # 7, 8. the CLI chain; the banks above are no longer needed
    del banks
    test_src = sources(1, 8, 1875, 128, (40, 130), 0, 1)
    cli = cli_chain(dev, src, test_src, chan4_model)
    del src

    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log('STEP ' + json.dumps({
        'step_ms': step_ms, 'pipeline_ms': pipe_ms, 'model_step_ms': model_ms,
        'banks_step_ms': bank_step_ms, 'banks_pipeline_ms': bank_pipe_ms,
        'batch': cfg.batch_size,
        'n_frame': cfg.n_frame, 'train_loss': logs['loss'],
        'val_loss': logs['val_loss'], 'card': smi}))
    log('SE ' + json.dumps({**{k: v for k, v in se.items()
                                if k != 'se_launches'}, **se_ref,
                             'card': smi}))
    log('MEL ' + json.dumps({**{k: v for k, v in mel.items()
                                 if k != 'mel_launches'}, **chan, **mel_ref,
                              'card': smi}))
    log('CLI ' + json.dumps({k: v for k, v in cli.items()
                             if not k.endswith('launches')}))
    log(smi)
    runs = {'synth_mag_f32': (launches, TRAIN_STEPS + VAL_STEPS),
            'synth_mag_bf16': (cli['bf16_launches'], cli['bf16_batches']),
            'synth_mag_int8': (cli['int8_launches'], cli['int8_batches']),
            'synth_flat_f32': (se['se_launches'], se['se_batches']),
            'synth_flat_bf16': (cli['se_bf16_launches'],
                                cli['se_cli_batches']),
            'synth_flat_int8': (cli['se_int8_launches'],
                                cli['se_cli_batches']),
            **{k: (mel['mel_launches'][run], n) for k, run, n in (
                ('synth_mel_f32', 'v9_float32', TRAIN_STEPS + VAL_STEPS),
                ('synth_mel_bf16', 'v9_bfloat16', 2),
                ('synth_mel_int8', 'v9_int8', 2))}}
    log(json.dumps({'kernels': [{
        'name': name, 'route': 'cuda',
        'source': 'challenge_tpu_torch/csrc/' + (
            'synth_mel.cu' if name.startswith('synth_mel') else 'synth.cu'),
        'replaces': 'challenge_tpu/ops/pallas_synth.py:79',
        'launches': runs[name][0].get(name, 0),
        'launches_per_step': runs[name][0].get(name, 0) / runs[name][1],
        'max_abs_err': max(errs[name].values()),
        **timing[name], 'library_ms': None} for name in runs]}))
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
