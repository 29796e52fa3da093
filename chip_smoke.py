#!/usr/bin/env python3
"""Smoke run of challenge_tpu_torch, the PyTorch + CUDA port, on one GPU.

    python3 chip_smoke.py            # needs one CUDA card, nvcc and the repo
    python3 chip_smoke.py --profile  # also a torch.profiler breakdown of steps
    python3 chip_smoke.py --cudnn-ab # also the model step with cuDNN's
                                     # algorithm timing off and on, each in
                                     # a fresh process (off, on, on, off)

Phases, in order; any failure raises, and the script then exits non-zero
without the result line:

1. build every hand-written CUDA kernel from challenge_tpu_torch/csrc with
   nvcc for sm_90a, and print the build seconds and ptxas' report;
2. make random spec banks on the card at a realistic size (32 backgrounds
   of 1,875 frames, 512 voices of 40-130 frames, 128 noises of 20-100,
   each [257, T, 4] float32, from a seed);
3. hold the synthesis kernel against its plain PyTorch version on the
   card: bit for bit (tolerance 0.0: both round every multiply and add of
   the same ordered sum and take the IEEE root), on draws of the main path
   (batch 12, 512 frames, 7 voice and 2 noise slots) and on adversarial
   draws (negative shifts, shifts of n_frame and beyond, inactive slots,
   long then short clips, no noise bank, a ragged row tile);
4. check the port on the card against the port on the CPU on a small input:
   synthesis bit for bit, log-mel within 1e-5 mean abs error, labels
   exact, and one training-mode forward and loss within 1e-5 relative;
5. the main path: ``get_model(Config(model_type='vad', v=8))`` at full width
   (base 48, td_dim 1024, 80 mels, 512 frames, batch 12),
   ``DevicePipeline`` and ``TrainLoop.fit`` for 5 training steps and 1
   validation step, with the kernel launch counts set to 0 just before and
   read just after: every batch must have gone through the kernel, and
   the losses must be finite;
6. times: the kernel and its plain version in turns (plain, kernel,
   kernel, plain) with CUDA events, its bound from this run's draws, and
   the training step (20 steps of one epoch, read back once, as ``fit``
   does), the batch pipeline and the model step on their own.

The last lines are the card's name and power limit as nvidia-smi gives
them, one JSON object ``{"kernels": [...]}`` and, last,
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

from challenge_tpu_torch import (
    Config, DevicePipeline, TrainLoop, build_banks, get_model)
from challenge_tpu_torch.data import mixture
from challenge_tpu_torch.data.pipeline import FeatureFn
from challenge_tpu_torch.models.registry import ModelBundle
from challenge_tpu_torch.models.vad import VADModel
from challenge_tpu_torch.ops import cuda
from challenge_tpu_torch.ops.augment import batch_mask_keep
from challenge_tpu_torch.ops.synth import (
    KERNEL, synthesize_magnitude, synthesize_magnitude_plain)
from challenge_tpu_torch.train.losses import binary_crossentropy

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA's data sheet
FP32_FLOPS = 67e12             # H100 SXM float32 outside the tensor cores
TRAIN_STEPS, VAL_STEPS = 5, 1


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


def draw_args(banks, d):
    """synthesize_magnitude's arguments for the draws ``d``."""
    return (d.n_frame, banks.backgrounds.flat, d.bidx, d.boff,
            banks.voices.flat, d.vidx, d.vshift, d.vw,
            None if d.nidx is None else banks.noises.flat, d.nidx, d.nshift,
            d.nw, d.vlens, d.nlens)


def max_abs_diff(args) -> float:
    out = synthesize_magnitude(*args)
    ref = synthesize_magnitude_plain(*args)
    torch.cuda.synchronize()
    if out.shape != ref.shape:
        raise AssertionError(f'kernel shape {out.shape}, plain {ref.shape}')
    return float((out - ref).abs().max())


def adversarial_cases(dev):
    """Synthesis arguments that probe the kernel's edges, made with numpy:
    negative shifts and shifts of n_frame and past it, w == 0 slots, clips
    longer than their stated length after short ones in the same slot, a
    lens past the bank's rows, no noise bank, and n_frame not a multiple
    of the kernel's 8-row tile."""
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


def synth_work(d, width: int):
    """(bytes, flops) that synthesizing the draws ``d`` needs, counting
    what this run's data needs: each sample's background window, the rows
    of every active clip (w != 0) that land in the window, the slot tables
    and the magnitude written, each once; a multiply and an add per clip
    element and 3 operations and a root per magnitude."""
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
    out = b * n_frame * (width // 2)
    nbytes = 4 * (b * n_frame * width + rows * width + out) + table
    return nbytes, 2 * rows * width + 4 * out


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
    input: the same draws, masks and weights on both."""
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
    return dict(synth_max_abs=synth_diff, logmel_mean_abs=feat_err,
                loss_gpu=loss_g, loss_cpu=loss_c)


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


def profile_steps(loop, it, steps: int) -> None:
    """torch.profiler over ``steps`` training steps: device time by kernel
    and the card's busy share of the wall time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        loop.run_epoch(it, steps, training=True)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    events = prof.key_averages()
    attr = ('self_device_time_total' if hasattr(events[0],
                                                'self_device_time_total')
            else 'self_cuda_time_total')
    device = [e for e in events
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
    log('PROFILE ' + json.dumps({
        'steps': steps, 'wall_ms': wall * 1e3, 'kernel_ms': busy_us / 1e3,
        'optimizer_range_ms': opt_us / 1e3,
        'synth_ms': sum(r[0] for r in rows if 'synth_mag' in r[1]) / 1e3}))


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
    secs = cuda.build(['synth'], verbose=True)
    log(f'build: {secs:.3f} s')

    # 2. banks at a realistic size
    t0 = time.perf_counter()
    src = sources(0, 32, 1875, 512, (40, 130), 128, (20, 100))
    banks = build_banks(*src, n_frame=512)
    del src
    torch.cuda.synchronize()
    bank_bytes = sum(t.numel() * t.element_size() for b in
                     (banks.backgrounds, banks.voices, banks.noises)
                     for t in (b.flat, b.lens, b.pos_mask))
    log(f'banks: {bank_bytes / 2**30:.3f} GiB on the card in '
        f'{time.perf_counter() - t0:.3f} s')

    # 3. the kernel against its plain version
    cfg = Config(model_type='vad', v=8)
    gen = torch.Generator(device=dev).manual_seed(1)
    main_draws = [mixture.draw(gen, banks, cfg.batch_size, cfg.n_frame,
                               max_voices=cfg.max_voices,
                               max_noises=cfg.max_noises, snr=cfg.snr)
                  for _ in range(16)]
    errs = {'main_path': max(max_abs_diff(draw_args(banks, d))
                             for d in main_draws[:4])}
    for name, args in adversarial_cases(dev).items():
        errs[name] = max_abs_diff(args)
    log('kernel vs plain, max abs diff: ' + json.dumps(errs))
    if any(e != 0.0 for e in errs.values()):
        raise AssertionError(f'{KERNEL} disagrees with its plain version')

    # 4. the card against the CPU on a small input
    log('card vs CPU, small input: ' + json.dumps(small_reference_check(dev)))

    # 5. the main path
    loop = TrainLoop(get_model(cfg))
    train_it = iter(DevicePipeline(banks, cfg))
    val_it = iter(DevicePipeline(banks, cfg, training=False))
    cuda.reset_launch_counts()
    hist = loop.fit(train_it, epochs=1, steps_per_epoch=TRAIN_STEPS,
                    validation_iter=val_it, validation_steps=VAL_STEPS)
    torch.cuda.synchronize()
    launches = dict(cuda.LAUNCHES)
    logs = hist[0]
    log('main path launches: ' + json.dumps(launches))
    if launches.get(KERNEL, 0) != TRAIN_STEPS + VAL_STEPS:
        raise AssertionError(f'{KERNEL} ran {launches.get(KERNEL, 0)} times '
                             f'for {TRAIN_STEPS + VAL_STEPS} batches')
    if not all(math.isfinite(logs[k]) for k in ('loss', 'val_loss')):
        raise AssertionError(f'non-finite losses: {logs}')

    # 6. times
    args = [draw_args(banks, d) for d in main_draws]
    kernel_ms, plain_ms = [], []
    for which in ('plain', 'kernel', 'kernel', 'plain'):
        if which == 'kernel':
            kernel_ms.append(gpu_ms(synthesize_magnitude, args, 64))
        else:
            plain_ms.append(gpu_ms(synthesize_magnitude_plain, args, 16))
    work = [synth_work(d, banks.backgrounds.flat.shape[-1])
            for d in main_draws]
    nbytes = sum(w[0] for w in work) / len(work)
    flops = sum(w[1] for w in work) / len(work)
    bound_ms = max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS) * 1e3
    log(f'synth: kernel {kernel_ms} ms, plain {plain_ms} ms, '
        f'{nbytes / 1e6:.3f} MB and {flops / 1e9:.4f} GFLOP per call, '
        f'bound {bound_ms * 1e3:.3f} us')

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

    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log('STEP ' + json.dumps({
        'step_ms': step_ms, 'pipeline_ms': pipe_ms, 'model_step_ms': model_ms,
        'batch': cfg.batch_size, 'n_frame': cfg.n_frame,
        'train_loss': logs['loss'], 'val_loss': logs['val_loss'],
        'card': smi}))
    log(smi)
    log(json.dumps({'kernels': [{
        'name': KERNEL, 'route': 'cuda',
        'source': 'challenge_tpu_torch/csrc/synth.cu',
        'replaces': 'challenge_tpu/ops/pallas_synth.py:79',
        'launches': launches[KERNEL],
        'launches_per_step': launches[KERNEL] / (TRAIN_STEPS + VAL_STEPS),
        'max_abs_err': max(errs.values()),
        'ms': sum(kernel_ms) / len(kernel_ms),
        'plain_ms': sum(plain_ms) / len(plain_ms),
        'bound_ms': bound_ms, 'bound_by': (
            'bytes' if nbytes / HBM_BYTES_PER_S >= flops / FP32_FLOPS
            else 'operations'),
        'library_ms': None}]}))
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
