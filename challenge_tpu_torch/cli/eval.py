"""Evaluation entry (counterpart: ``challenge_tpu/cli/eval.py``; reference:
eval.py:42-65).

    python -m challenge_tpu_torch.cli.eval --name <run> [--p] [--path DIR] \
        [--export_aot PATH] [--export_aot_eval PATH] [--device cpu]

Scores the checkpoint ``{path}/{name}.h5`` (a ``torch.save`` file or a
Keras HDF5 file, told apart by its magic bytes) on ``./*.wav`` against
``./sample_answer.json``. ``--p`` parses the hyperparameters back out of
the run name (reference: eval.py:48-60). The run goes to ``cuda`` unless
given ``--device cpu``.

``--export_aot PATH`` also writes the loaded model's forward as a
``torch.export`` artifact, and ``--export_aot_eval PATH`` the whole eval
chain, raw PCM to thresholded frame grids, sized to the WAV corpus in the
current directory (``interop/aot.py``). Either serves on the device it
was exported on, through ``interop.aot.load_infer``.
"""

from __future__ import annotations

import os
from glob import glob

from challenge_tpu_torch.cli.sj_train import DEVICE_FLAG
from challenge_tpu_torch.config import config_from_args, parse_run_name
from challenge_tpu_torch.evaluate.infer import _wav_headers, evaluate
from challenge_tpu_torch.models.registry import get_model
from challenge_tpu_torch.train.checkpoint import load_weights


def main(argv=None):
    """Returns the per-clip ER list."""
    config = config_from_args(argv, extra={
        '--verbose': dict(help='verbose', type=bool, default=True),
        '--p': dict(help='parsing name', action='store_true'),
        '--path': dict(type=str, default=''),
        '--export_aot': dict(type=str, default='',
                             help='also write a torch.export serving '
                                  'artifact to this path'),
        '--export_aot_eval': dict(type=str, default='',
                                  help='also write the WHOLE eval chain '
                                       '(PCM -> thresholded frame grids) '
                                       'as a torch.export artifact, sized '
                                       'to the cwd wav corpus'),
        **DEVICE_FLAG})
    extra = config.extra_args
    if extra['p']:
        config = parse_run_name(config, config.name)
    bundle = get_model(config, device=extra['device'])
    bundle.module.load_state_dict(load_weights(
        os.path.join(extra['path'], f'{config.name}.h5'), bundle.device,
        bundle))
    if extra['export_aot']:
        from challenge_tpu_torch.interop.aot import export_infer
        export_infer(bundle, config, path=extra['export_aot'])
        print(f'wrote serving artifact: {extra["export_aot"]}')
    if extra['export_aot_eval']:
        from challenge_tpu_torch.interop.aot import export_eval
        paths = sorted(glob('*.wav'))
        if not paths:
            raise ValueError(
                '--export_aot_eval sizes the program from the wav corpus '
                'in the CURRENT directory, and there are no *.wav files '
                f'here ({os.getcwd()})')
        hdr = _wav_headers(paths)
        if hdr is None:
            raise ValueError(
                '--export_aot_eval needs a uniform wav corpus '
                '(16-bit PCM, one shared sample rate and channel count) '
                f'— the {len(paths)} *.wav files here are mixed-format')
        lens, chan = hdr
        export_eval(bundle, config, s_max=int(lens.max()),
                    wav_channels=chan, path=extra['export_aot_eval'])
        print(f'wrote eval-chain artifact: {extra["export_aot_eval"]}')
    return evaluate(config, bundle.module, verbose=extra['verbose'])


if __name__ == '__main__':
    main()
