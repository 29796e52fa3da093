"""Run configuration and the run-name grammar.

A copy of ``challenge_tpu/config.py``: importing that module would run
``challenge_tpu/__init__.py`` and with it JAX, so the port keeps its own.
The two ``Config`` dataclasses must stay field-for-field equal, defaults
included, except ``datapath`` (a test pins it). Fields that only the JAX
package reads (mesh, streaming, bank dtypes) are kept so run names and CLI
flags stay interchangeable.

Mirrors the flag surface of the reference trainer (reference: sj_train.py:20-71)
as a plain dataclass so programs can build configs directly, plus an argparse
adapter for the CLI shims. The run-name grammar
``{name}_{model}_{v}_{lr}_{batch}_{opt}_{mel}_{chan}_{loss}_{framelen}``
(reference: sj_train.py:424-429) is de-facto API — eval/get_csv_data parse
hyperparameters back out of file names (reference: eval.py:48-60,
get_csv_data.py:40-51) — so it is preserved verbatim here.
"""

from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass
from typing import Optional


@dataclass
class Config:
    # MODEL
    name: str = ''
    gpus: str = '-1'                       # kept for CLI parity; unused
    model: int = 0                         # EfficientNet variant (B{model})
    model_type: str = 'vad'                # 'vad' | 'eff' | 'se'
    v: int = 1
    pretrain: bool = False
    n_layers: int = 0
    n_dim: int = 256
    n_chan: int = 2
    n_classes: int = 3
    patience: int = 10

    # DATA
    mse_multiplier: int = 1
    # the JAX Config's default is an absolute dataset path on the
    # reference authors' machines; its CLI reads from the working
    # directory when that path is absent (cli/sj_train.py:30), which ''
    # does everywhere
    datapath: str = ''
    background_sounds: str = 'drone_normed_complex_v4.pickle'
    voices: str = 'voice_normed_complex_v3.pickle'
    labels: str = 'voice_labels_mfc_v3.npy'
    noises: str = 'noises_specs_v2.pickle'
    test_background_sounds: str = 'test_drone_normed_complex_v2.pickle'
    test_voices: str = 'test_voice_normed_complex.pickle'
    test_labels: str = 'test_voice_labels_mfc.npy'
    n_mels: int = 80

    # TRAINING
    optimizer: str = 'adam'                # adam | sgd | rmsprop | adabelief
    lr: float = 1e-3
    end_lr: float = 1e-4
    lr_power: float = 0.5
    lr_div: float = 2.
    clipvalue: float = 0.01
    epochs: int = 300
    batch_size: int = 12
    n_frame: int = 512
    steps_per_epoch: int = 100
    l1: float = 0.
    l2: float = 1e-6
    loss: str = 'BCE'

    # AUGMENTATION
    snr: float = -20.
    max_voices: int = 7
    max_noises: int = 2

    # TPU-native extensions (absent in the reference; additive only)
    compute_dtype: str = 'float32'         # 'bfloat16' = mixed-precision model
    bank_dtype: str = 'float32'            # 'bfloat16' halves spec-bank HBM
                                           # footprint + synthesis DMA traffic
                                           # (mixing still accumulates in f32);
                                           # 'int8' halves both again (per-item
                                           # max-abs quantization, dequant
                                           # scales folded into the mix)
    remat: bool = False                    # rematerialize activations in the
                                           # backward pass (jax.checkpoint):
                                           # ~1 extra fwd of FLOPs for much
                                           # less HBM at big batch/model
    seed: int = 0
    n_devices: int = 0                     # 0 = use all visible devices
    bank_shard: bool = False               # split the spec banks' clip axis
                                           # across the mesh (dataset HBM
                                           # capacity scales with chips; each
                                           # device synthesizes from its
                                           # local shard)
    stream_chunks: int = 0                 # >=2: rotate the training spec set
                                           # through the device as N host-
                                           # resident chunks (datasets larger
                                           # than HBM; next chunk uploads
                                           # while the current one trains)
    chunk_steps: int = 4                   # fused dispatches per chunk before
                                           # the rotation advances
    steps_per_call: int = 1                # train steps fused per host dispatch
    grad_accum: int = 1                    # >1: gradient accumulation — scan
                                           # N synthesize+fwd+bwd microbatches
                                           # per optimizer step, averaging the
                                           # grads before one AGC + apply
                                           # (effective batch N*batch_size at
                                           # one microbatch's activation HBM)
    ckpt_dir: str = ''                     # Orbax full-train-state checkpoints
    resume: bool = False                   # restore latest state from ckpt_dir
    ckpt_every_epochs: int = 10
    keras_ckpt: bool = False               # write the {run}.h5 / _SWA.h5 /
                                           # _sample.h5 trio as REAL Keras
                                           # legacy HDF5 (loadable by the
                                           # reference's model.load_weights)
                                           # instead of flax msgpack

    def replace(self, **kw) -> 'Config':
        return dataclasses.replace(self, **kw)

    # ------------------------------------------------------------------ name
    @property
    def model_first_name(self) -> str:
        # reference: sj_train.py:417-422
        if self.model_type == 'eff':
            return f'B{self.model}'
        return self.model_type  # 'se' or 'vad'

    def run_name(self) -> str:
        """Build the canonical run name (reference: sj_train.py:416-429).

        Note the optimizer field contributes the literal token ``opt_<name>``,
        i.e. two '_'-separated tokens, which downstream parsers rely on.
        """
        prefix = (self.name + '_') if self.name != '' else ''
        name = prefix + '_'.join([
            self.model_first_name, f'v{self.v}', f'lr{self.lr}',
            f'batch{self.batch_size}', f'opt_{self.optimizer}',
            f'mel{self.n_mels}', f'chan{self.n_chan}',
            f'{self.loss.upper()}', f'framelen{self.n_frame}'])
        if self.model_type == 'se' and self.v == 9 and self.pretrain:
            name += '_weight'
        return name


def parse_run_name(config: Config, run_name: str) -> Config:
    """Recover hyperparameters from a run name (reference: eval.py:48-60).

    Token layout after the optional free-form prefix:
      0: 'vad' | 'se' | 'B{n}'   1: 'v{#}'    2: 'lr{f}'   3: 'batch{n}'
      4: 'opt' 5: '{optname}'    6: 'mel{n}'  7: 'chan{n}' 8: '{LOSS}'
      9: 'framelen{n}'
    """
    tokens = run_name.split('_')
    # drop free-form prefix tokens until the model token
    while tokens and tokens[0] not in ('vad', 'se') and not (
            tokens[0][:1] == 'B' and tokens[0][1:].isdigit()):
        tokens = tokens[1:]
    if not tokens:
        raise ValueError(f'cannot parse run name: {run_name!r}')
    updates = {}
    if tokens[0] == 'vad':
        updates['model_type'] = 'vad'
        updates['model'] = 1
    elif tokens[0] == 'se':
        updates['model_type'] = 'se'
    else:
        updates['model_type'] = 'eff'
        updates['model'] = int(tokens[0][1:])
    updates['v'] = int(tokens[1][1:])
    updates['lr'] = float(tokens[2][2:])
    updates['batch_size'] = int(tokens[3][5:])
    updates['optimizer'] = tokens[5]
    updates['n_mels'] = int(tokens[6][3:])
    updates['n_chan'] = int(tokens[7][4:])
    updates['loss'] = tokens[8]
    updates['n_frame'] = int(tokens[9].split('framelen')[-1])
    return config.replace(**updates)


def str2bool(v: str) -> bool:
    """'False'/'0'/'no' actually mean False (used for the additive TPU-native
    bool flags; the reference's own flags keep its ``type=bool`` argparse
    quirk, where any non-empty value is True — sj_train.py:23)."""
    if isinstance(v, bool):
        return v
    return v.strip().lower() not in ('', 'false', '0', 'no', 'none')


# additive (non-reference) flags get sane parsing; reference flags keep the
# reference's argparse behavior verbatim
_ADDITIVE_BOOL_FLAGS = ('resume', 'remat', 'bank_shard', 'keras_ckpt')
_CHOICES = {'bank_dtype': ['float32', 'bfloat16', 'int8'],
            # the reference validates these at parse time
            # (sj_train.py:26 and 49-50) — keep typos failing fast instead
            # of deep inside bank building / TrainLoop construction
            'model_type': ['vad', 'eff', 'se'],
            'optimizer': ['adam', 'sgd', 'rmsprop', 'adabelief']}


def build_argparser() -> argparse.ArgumentParser:
    """The reference CLI flag surface (reference: sj_train.py:20-71)."""
    p = argparse.ArgumentParser()
    for f in dataclasses.fields(Config):
        if f.name in _ADDITIVE_BOOL_FLAGS:
            p.add_argument(f'--{f.name}', type=str2bool, default=f.default)
        elif f.type in ('bool', bool):
            p.add_argument(f'--{f.name}', type=bool, default=f.default)
        else:
            p.add_argument(f'--{f.name}', type=type(f.default),
                           default=f.default, choices=_CHOICES.get(f.name))
    return p


def config_from_args(argv: Optional[list] = None,
                     extra: Optional[dict] = None) -> Config:
    parser = build_argparser()
    if extra:
        for flag, kw in extra.items():
            parser.add_argument(flag, **kw)
    ns = parser.parse_args(argv)
    known = {f.name for f in dataclasses.fields(Config)}
    cfg = Config(**{k: v for k, v in vars(ns).items() if k in known})
    cfg.extra_args = {k: v for k, v in vars(ns).items() if k not in known}
    return cfg
