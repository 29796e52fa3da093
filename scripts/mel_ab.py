#!/usr/bin/env python3
"""Time the fused mel kernel (B4, ``challenge_tpu_torch/csrc/synth_mel.cu``)
against an earlier commit's on one CUDA card, in turns.

    mkdir -p build/parent
    git archive <commit> challenge_tpu_torch | tar -x -C build/parent
    python3 scripts/mel_ab.py --parent build/parent [--steps]

The kernels: builds the earlier commit's ``synth_mel.cu`` (with its own
``synth_common.cuh``) beside this tree's, both ``nvcc`` started together,
and prints ptxas' report. Both take the same C arguments. On the main
path's draws of vad v9 (batch 12, 512 frames, 80 mels, 7 voice and 2
noise slots; float32, bfloat16 and int8 banks built from the same
sources, as ``chip_smoke.py`` phases 2 and 6 make them, with training
masks) each must equal the plain version (max abs difference 0.0, mel and
min/max); then, per bank dtype, both are timed with ``chip_smoke.gpu_ms``
in one process, in turns (earlier, this, this, earlier), twice.

``--steps`` also times vad v9's fused-mel training step (20 steps, after
3) and its batch pipeline (20 batches) of each tree, in a fresh process
per turn (earlier, this, this, earlier): each process imports the package
of its tree and builds that tree's kernel.

Every measurement is printed as one JSON line, with the card's name and
power limit, and all of them are written to ``build/mel_ab/mel_ab.json``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BUILD = ROOT / 'build' / 'mel_ab'
REPS = 200
STEPS = 20


def smi() -> str:
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def step_times(tree: Path) -> dict:
    """vad v9's fused-mel step and batch pipeline, ms, through the package
    of ``tree`` (this tree's or the earlier commit's)."""
    sys.path[:0] = [str(tree), str(ROOT)]
    import torch

    import chip_smoke as cs
    from challenge_tpu_torch import Config, TrainLoop, build_banks, get_model
    from challenge_tpu_torch.ops import cuda, synth
    src = cs.sources(0, 32, 1875, 512, (40, 130), 128, (20, 100))
    banks = build_banks(*src, n_frame=512, flat_dtype='float32')
    cfg = Config(model_type='vad', v=9)
    loop = TrainLoop(get_model(cfg))
    it = cs.feature_iter(banks, cfg)
    loop.run_epoch(it, 3, training=True)
    cuda.reset_launch_counts()
    step = cs.wall_ms(lambda: loop.run_epoch(it, STEPS, training=True),
                      1) / STEPS
    pipe = cs.wall_ms(lambda: next(it), STEPS)
    kernel = synth.MEL_KERNELS[torch.float32]
    if dict(cuda.LAUNCHES) != {kernel: 2 * STEPS}:
        raise AssertionError(f'launches {dict(cuda.LAUNCHES)}')
    return dict(v9_step_ms=step, fused_mel_pipeline_ms=pipe,
                package=str(Path(cuda.__file__).resolve().parents[1]))


def build(parent_csrc: Path, cuda) -> dict:
    """The earlier commit's library and this tree's, loaded."""
    BUILD.mkdir(parents=True, exist_ok=True)
    out = BUILD / 'libparent.so'
    proc = subprocess.Popen(
        [cuda._nvcc(), *cuda.NVCC_FLAGS, '-Xptxas', '-v', '-o', str(out),
         str(parent_csrc / 'synth_mel.cu')],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    cuda.build(['synth_mel'], verbose=True)
    log, _ = proc.communicate()
    print(f'--- nvcc parent synth_mel.cu\n{log}', flush=True)
    if proc.returncode != 0:
        raise RuntimeError('nvcc of the earlier synth_mel.cu failed')
    return {'parent': ctypes.CDLL(str(out)), 'change': cuda.load('synth_mel')}


def kernel_times(parent_csrc: Path, emit) -> None:
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    from challenge_tpu_torch import Config, build_banks
    from challenge_tpu_torch.data import mixture
    from challenge_tpu_torch.data.pipeline import FeatureFn
    from challenge_tpu_torch.data.specset import FLAT_DTYPES
    from challenge_tpu_torch.ops import cuda, synth

    dev = torch.device('cuda', 0)
    libs = build(parent_csrc, cuda)
    src = cs.sources(0, 32, 1875, 512, (40, 130), 128, (20, 100))
    banks = {name: build_banks(*src, n_frame=512, flat_dtype=name)
             for name in FLAT_DTYPES}
    cfg = Config(model_type='vad', v=9)
    gen = torch.Generator(device=dev).manual_seed(1)
    draws = [mixture.draw(gen, banks['float32'], cfg.batch_size, cfg.n_frame,
                          max_voices=cfg.max_voices,
                          max_noises=cfg.max_noises, snr=cfg.snr)
             for _ in range(16)]
    mel_fn = FeatureFn(cfg, device=dev, fused_mel=True)
    band, melm = mel_fn.band, mel_fn.melm
    mask_gen = torch.Generator(device=dev).manual_seed(3)
    masks = []
    for _ in draws:
        tmask, fmask = mel_fn.masks(mask_gen)
        masks.append((tmask, fmask.repeat(1, 2)))
    freq, n_mels = melm.shape
    stream = torch.cuda.current_stream().cuda_stream
    for name, dt in FLAT_DTYPES.items():
        kernel = synth.MEL_KERNELS[dt]
        fns = {}
        for which, lib in libs.items():
            fns[which] = fn = getattr(lib, kernel)
            fn.argtypes, fn.restype = synth._MEL_ARGTYPES, ctypes.c_int
        calls = []
        for d, (tmask, fmask) in zip(draws, masks):
            args = mixture.synth_args(banks[name], d)
            src_args, keep = synth._source_args('mel_ab', *args[1:])
            b, width = args[2].shape[0], args[1].shape[-1]
            mel = torch.empty((b, n_mels, cfg.n_frame, width // 2 // freq),
                              device=dev)
            mm = torch.empty((b, 2), device=dev)
            ptrs = src_args + [
                band.off.data_ptr(), band.row.data_ptr(), band.w.data_ptr(),
                band.row.numel(), n_mels, band.f_lo, band.n_f, freq,
                tmask.data_ptr(), fmask.data_ptr(), mel.data_ptr(),
                mm.data_ptr(), b, cfg.n_frame, width, stream]
            calls.append((ptrs, args, keep, mel, mm, tmask, fmask))

        def run(which, c):
            err = fns[which](*c[0])
            if err != 0:
                raise RuntimeError(f'{which} {kernel}: CUDA error {err}')

        _, args, _, mel, mm, tmask, fmask = calls[0]
        ref_mel, ref_mm = synth.synthesize_mel_plain(
            *args, melm=melm, tmask=tmask, fmask=fmask, band=band)
        errs = {}
        for which in fns:
            mel.fill_(float('nan'))
            mm.fill_(float('nan'))
            run(which, calls[0])
            torch.cuda.synchronize()
            errs[which] = max(float((mel - ref_mel).abs().max()),
                              float((mm - ref_mm).abs().max()))
        emit(what='max_abs_err', kernel=kernel, errs=errs)
        if any(e != 0.0 for e in errs.values()):
            raise AssertionError(f'{kernel}: disagrees: {errs}')
        times = {which: [] for which in fns}
        for which in ('parent', 'change', 'change', 'parent') * 2:
            times[which].append(cs.gpu_ms(
                lambda c, which=which: run(which, c),
                [(c,) for c in calls], REPS))
        width = banks[name].backgrounds.flat.shape[-1]
        nbytes = sum(cs.mel_work(d, width, dt, band, n_mels)[0]
                     for d in draws) / len(draws)
        emit(what='kernel_ms', kernel=kernel,
             bound_ms=nbytes / cs.HBM_BYTES_PER_S * 1e3, mb=nbytes / 1e6,
             times=times,
             mean={k: sum(v) / len(v) for k, v in times.items()})
    empty = [cs.gpu_ms(torch.cuda._sleep, [(0,)], 256) for _ in range(2)]
    emit(what='empty_launch_ms', times=empty)


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument('--parent', type=Path, required=True,
                    help='a directory holding the earlier commit\'s '
                         'challenge_tpu_torch')
    ap.add_argument('--steps', action='store_true')
    ap.add_argument('--step-tree', type=Path,
                    help='(internal) time the step of this tree\'s package '
                         'and print it as JSON')
    opts = ap.parse_args(argv)
    if opts.step_tree is not None:
        print(json.dumps(step_times(opts.step_tree.resolve())), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print('mel_ab: no CUDA device', file=sys.stderr)
        return 1
    parent = opts.parent.resolve()
    card = smi()
    results = []

    def emit(**rec):
        rec['card'] = card
        results.append(rec)
        print(json.dumps(rec), flush=True)

    kernel_times(parent / 'challenge_tpu_torch' / 'csrc', emit)
    if opts.steps:
        trees = {'parent': parent, 'change': ROOT}
        steps = {'parent': [], 'change': []}
        for which in ('parent', 'change', 'change', 'parent'):
            out = subprocess.run(
                [sys.executable, str(Path(__file__).resolve()),
                 '--parent', str(parent), '--step-tree', str(trees[which])],
                capture_output=True, text=True, timeout=600,
                env={**os.environ, 'PYTHONPATH': ''})
            if out.returncode != 0:
                raise RuntimeError(f'{which} step run failed:\n{out.stderr}')
            rec = json.loads(out.stdout.strip().splitlines()[-1])
            if Path(rec.pop('package')) != trees[which] / 'challenge_tpu_torch':
                raise AssertionError(f'{which}: imported the wrong package')
            steps[which].append(rec)
        emit(what='steps', turns=steps)

    (BUILD / 'mel_ab.json').write_text(json.dumps(results, indent=1))
    print(card)
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
