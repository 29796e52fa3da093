"""Experiment-results aggregator (counterpart:
``challenge_tpu/cli/get_csv_data.py``; reference: get_csv_data.py:12-119).

    python -m challenge_tpu_torch.cli.get_csv_data --path DIR [--patience N] \
        [--device cpu]

Walks ``--path`` for training CSV logs, parses the hyperparameters back out
of each file name, rebuilds the model, re-evaluates the {run}.h5 /
{run}_SWA.h5 / {run}_sample.h5 trio (``torch.save`` or Keras HDF5 files
alike) on ``./*.wav`` with overlap_hop = framelen // 2, and writes
``result.csv`` into ``--path`` (headers verbatim, Korean included). As in
the reference, the row takes the log line ``patience`` epochs before the
last, and a run whose log has no more than ``patience + 5`` lines is not
evaluated: its checkpoints score 1.0. A checkpoint that does not load into
the rebuilt model (another family or version) leaves its cell out, as
JAX's does; the eval itself is not guarded. The run goes to ``cuda``
unless given ``--device cpu``.
"""

from __future__ import annotations

import csv
import os
from glob import glob

import numpy as np
import torch

from challenge_tpu_torch.cli.sj_train import DEVICE_FLAG
from challenge_tpu_torch.config import config_from_args
from challenge_tpu_torch.evaluate.infer import evaluate
from challenge_tpu_torch.models.registry import get_model
from challenge_tpu_torch.train.checkpoint import load_weights

CATEGORY = ['이름', '모델', 'version', 'batch', 'lr', 'optimizer',
            'loss function', 'input', 'chan', 'output', 'epoch', 'cos_sim',
            'er', 'f1_score', 'loss', 'val_cos_sim', 'val_er', 'val_f1_score',
            'val_loss', 'test_er', 'swa_test_er', 'sample_test_er']


def _parse_name(filename: str):
    """The run-name fields (model, version, lr, batch, optimizer, mels,
    chan, loss, framelen) of a log's file name, or None for a CSV that is
    not a run log (JAX: get_csv_data.py:49-83, the reference's ``find``
    scans, with ``se_v`` anchoring the se family)."""
    if 'vad' in filename:
        name = filename[filename.find('vad'):].split('_')
    elif 'se_v' in filename:
        name = filename[filename.find('se_v'):].split('_')
    else:
        name = filename[filename.find('B'):].split('_')
    try:
        return name, (name[0], name[1][1:], name[2][2:],
                      name[3].split('batch')[-1], name[5],
                      name[6].split('mel')[-1], name[7].split('chan')[-1],
                      name[8], name[9].split('framelen')[-1])
    except IndexError:
        return name, None


def main(config=None, argv=None):
    """Writes ``result.csv`` and returns its rows, the header first."""
    if config is None:
        config = config_from_args(argv, extra={
            '--path': dict(type=str, default=''), **DEVICE_FLAG})
    extra = getattr(config, 'extra_args', {})
    data_path = extra.get('path', '')
    paths = sorted(glob(os.path.join(data_path, '*.csv')))
    result_path = os.path.join(data_path, 'result.csv')
    prev_lines = [CATEGORY]

    for path in paths:
        if path == result_path:
            continue
        with open(path, 'r') as f:
            lines = list(csv.reader(f))[1:]
        if not lines:
            continue
        data = lines[max(len(lines) - config.patience, 0)]
        filename = os.path.splitext(path.split('/')[-1])[0]
        name, fields = _parse_name(filename)
        if fields is None:
            print(f'skipping {filename!r}: not a run-name-grammar log')
            continue
        (model_name, version, lr, batch, opt, n_mel, chan, loss,
         framelen) = fields
        if 'vad' in name:
            config.model_type = 'vad'
        elif 'se' in name:
            config.model_type = 'se'
        else:
            config.model_type = 'eff'
        evaluation = max(len(lines) - config.patience, 0) > 5

        config.model = int(model_name[1:]) if model_name[1:].isdigit() else 0
        config.v = int(version)
        config.n_mels = int(n_mel)
        config.n_chan = int(chan)
        config.n_frame = int(framelen)
        try:
            bundle = get_model(config, device=extra.get('device'))
        except ValueError:
            continue

        # the output-shape column: the reference reads model.output.shape
        module = bundle.module.eval()
        with torch.no_grad():
            probe = module(torch.zeros((1,) + bundle.input_shape,
                                       device=bundle.device))
        if config.model_type == 'se':
            probe = probe[0]
        row = [filename, 'vad' if config.model_type == 'vad' else model_name,
               version, batch, lr, opt, loss,
               str((config.n_mels if config.model_type != 'se' else 256,
                    config.n_frame)),
               chan, str(tuple(probe.shape[1:]))] + data

        for suffix in ('', '_SWA', '_sample'):
            ckpt = f'{os.path.splitext(path)[0]}{suffix}.h5'
            if not os.path.exists(ckpt):
                row += ['None']
                continue
            if evaluation:
                try:
                    module.load_state_dict(load_weights(ckpt, bundle.device,
                                                        bundle))
                except (ValueError, NotImplementedError, RuntimeError) as e:
                    print(f'skipping {ckpt!r}: {e}')
                    continue
                score = evaluate(config, module,
                                 overlap_hop=int(framelen) // 2, verbose=True)
            else:
                score = 1.0
            row += [np.mean(score)]

        prev_lines.append(row)

    with open(result_path, 'w') as f:
        csv.writer(f).writerows(prev_lines)
    return prev_lines


if __name__ == '__main__':
    main()
