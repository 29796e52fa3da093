"""Evaluation entry (counterpart: ``challenge_tpu/cli/eval.py``; reference:
eval.py:42-65).

    python -m challenge_tpu_torch.cli.eval --name <run> [--p] [--path DIR] \
        [--device cpu]

Scores the checkpoint ``{path}/{name}.h5`` on ``./*.wav`` against
``./sample_answer.json``. ``--p`` parses the hyperparameters back out of
the run name (reference: eval.py:48-60). The run goes to ``cuda`` unless
given ``--device cpu``. The AOT exports wait for ROADMAP A15.
"""

from __future__ import annotations

import os

from challenge_tpu_torch.cli.sj_train import DEVICE_FLAG
from challenge_tpu_torch.config import config_from_args, parse_run_name
from challenge_tpu_torch.evaluate.infer import evaluate
from challenge_tpu_torch.models.registry import get_model
from challenge_tpu_torch.train.checkpoint import load_weights


def main(argv=None):
    """Returns the per-clip ER list."""
    config = config_from_args(argv, extra={
        '--verbose': dict(help='verbose', type=bool, default=True),
        '--p': dict(help='parsing name', action='store_true'),
        '--path': dict(type=str, default=''),
        '--export_aot': dict(type=str, default=''),
        '--export_aot_eval': dict(type=str, default=''),
        **DEVICE_FLAG})
    extra = config.extra_args
    for flag in ('export_aot', 'export_aot_eval'):
        if extra[flag]:
            raise NotImplementedError(
                f'--{flag} is not ported yet (ROADMAP A15)')
    if extra['p']:
        config = parse_run_name(config, config.name)
    bundle = get_model(config, device=extra['device'])
    bundle.module.load_state_dict(load_weights(
        os.path.join(extra['path'], f'{config.name}.h5'), bundle.device))
    return evaluate(config, bundle.module, verbose=extra['verbose'])


if __name__ == '__main__':
    main()
