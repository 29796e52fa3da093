"""How the program is built for a configuration: one module a CLI of the
program (``sj_train``, ``trainer``), named by a configuration file's
``entry``, with ``build_fit``.
Each imports the program inside its functions, so that the harness can be
imported, and its manifest checked, where the program cannot run."""

from __future__ import annotations

from typing import NamedTuple


class Program(NamedTuple):
    """A fit cell's program: the loop, and in iterator mode the training
    and validation iterators handed to ``fit`` (None in banks mode)."""
    loop: object
    train_iter: object
    val_iter: object


def check_sizes(cfg: dict, config, n_classes: int, multiplier) -> None:
    """Raise unless the CLI's configuration runs the sizes and the training
    settings that the configuration file states (the reference reads the
    file)."""
    m, t = cfg['model'], cfg['train']
    want = {'n_mels': m['n_mels'], 'n_frame': m['n_frame'],
            'batch_size': m['batch_size'], 'n_chan': m['n_chan'],
            'compute_dtype': cfg['compute_dtype'],
            'bank_dtype': cfg['bank_dtype'], 'optimizer': t['optimizer'],
            'lr': t['lr'], 'clipvalue': t['clipvalue'],
            'max_voices': t['max_voices'], 'max_noises': t['max_noises'],
            'snr': t['snr']}
    got = {k: getattr(config, k) for k in want}
    got['n_classes'], want['n_classes'] = n_classes, m['n_classes']
    got['multiplier'], want['multiplier'] = multiplier, t['multiplier']
    bad = {k: (got[k], want[k]) for k in want if got[k] != want[k]}
    if bad:
        raise ValueError(f"{cfg['name']}: the program's configuration "
                         f'differs from the file (program, file): {bad}')
