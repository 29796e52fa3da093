"""Density-label training entry (counterpart: ``challenge_tpu/cli/trainer.py``;
reference: trainer.py:213-289).

    python -m challenge_tpu_torch.cli.trainer --name dens --n_chan 2 \
        [--bank_dtype int8] [--device cpu] ...

An EfficientNet (``--model``, default EfficientNetB4) with the density head
regresses density labels (``FeatureFn(variant='density')``) under the
count + total-variation loss, with AdaBelief by default, an l1/l2 kernel
penalty when ``--l2`` > 0 (the reference's gate: an l1-only run is
unregularized), and cos_sim as its only metric. Callbacks, in the
reference's order: the CSV log ``{name}.log``, SWA from epochs / 2,
``{name}.h5`` at each new best ``val_loss`` (a Keras HDF5 file with
``--keras_ckpt True``, as ``_SWA.h5``), a stop on NaN, then the warmup
schedule, or with ``--pretrain`` (the reference's ``type=bool`` flag: any
value is True) ``{name}.h5`` is loaded first and the learning rate cut on
plateaus of the training loss. The SWA average is written to
``{name}_SWA.h5``; a run too short to fold SWA raises ``NO_SWA_ERROR``,
as JAX's does.

On a data-parallel mesh, or with ``--grad_accum`` > 1 or
``--stream_chunks`` >= 2, the run trains in banks mode, the fused step over the density batches
(``TrainLoop(variant='density')``), on resident banks or on a rotation of
host chunks, as JAX's does (cli/trainer.py:175-192); otherwise it trains
from the reference's batch iterators, where ``--steps_per_call`` does not
apply. ``--remat`` rematerialises the forward in either mode.
``--n_devices`` and ``--bank_shard`` follow JAX's device policy and
train over a mesh as ``cli.sj_train`` does, and
``--ckpt_dir``, ``--ckpt_every_epochs`` and ``--resume`` save and restore
the full train state, as for ``cli.sj_train``. A resumed iterator-mode run
draws its batches from a pipeline started anew at the seed, as JAX's
``DevicePipeline`` restarts its key chain (ROADMAP C15).

The flags are the JAX CLI's, plus ``--device``: the run goes to ``cuda``
unless given ``--device cpu``. ``--datapath`` defaults to the working
directory (the JAX CLI's default is a dataset path of the reference
authors). The banks are always slim, as for ``cli.sj_train``. At its
default ``--n_chan 1`` the JAX trainer fails its first step, since the
density features keep 2 channels and the model takes 1 (ROADMAP C9); this
CLI refuses every n_chan but 2 up front.
"""

from __future__ import annotations

import argparse

from challenge_tpu_torch.cli.sj_train import make_banks, resume
from challenge_tpu_torch.config import Config, str2bool
from challenge_tpu_torch.data.pipeline import DevicePipeline
from challenge_tpu_torch.device import resolve_device
from challenge_tpu_torch.models.registry import get_density_model
from challenge_tpu_torch.parallel import launch
from challenge_tpu_torch.parallel.mesh import (
    current, is_writer, mesh_for_config)
from challenge_tpu_torch.train import (
    SWA, CSVLogger, LearningRateScheduler, ModelCheckpoint, ReduceLROnPlateau,
    TerminateOnNaN, TrainLoop, TrainStateCheckpoint, custom_scheduler,
    load_weights, save_weights)
from challenge_tpu_torch.train.losses import density_loss
from challenge_tpu_torch.train.regularizers import (
    apply_kernel_regularizer, l1_l2)

def build_args() -> argparse.ArgumentParser:
    """The JAX CLI's flag surface (cli/trainer.py:26-91; reference:
    trainer.py:17-60), plus ``--device``."""
    args = argparse.ArgumentParser()
    args.add_argument('--name', type=str, required=True)
    args.add_argument('--model', type=str, default='EfficientNetB4')
    args.add_argument('--pretrain', type=bool, default=False)
    args.add_argument('--n_layers', type=int, default=0)
    args.add_argument('--n_dim', type=int, default=256)
    args.add_argument('--n_chan', type=int, default=1)
    args.add_argument('--n_classes', type=int, default=3)
    args.add_argument('--datapath', type=str, default='')
    args.add_argument('--background_sounds', type=str,
                      default='drone_normed_complex_v3.pickle')
    args.add_argument('--voices', type=str,
                      default='voice_normed_complex_v3.pickle')
    args.add_argument('--labels', type=str, default='voice_labels_mfc_v3.npy')
    args.add_argument('--noises', type=str, default='noises_specs_v2.pickle')
    args.add_argument('--test_background_sounds', type=str,
                      default='dummy_specs.pickle')
    args.add_argument('--test_voices', type=str, default='dummy_specs.pickle')
    args.add_argument('--test_labels', type=str, default='dummy_labels.npy')
    args.add_argument('--n_mels', type=int, default=80)
    args.add_argument('--optimizer', type=str, default='adabelief',
                      choices=['adam', 'sgd', 'rmsprop', 'adabelief'])
    args.add_argument('--lr', type=float, default=1e-4)
    args.add_argument('--end_lr', type=float, default=1e-4)
    args.add_argument('--lr_power', type=float, default=0.5)
    args.add_argument('--lr_div', type=float, default=2)
    args.add_argument('--clipvalue', type=float, default=0.01)
    args.add_argument('--epochs', type=int, default=500)
    args.add_argument('--batch_size', type=int, default=12)
    args.add_argument('--n_frame', type=int, default=2048)
    args.add_argument('--steps_per_epoch', type=int, default=100)
    args.add_argument('--l1', type=float, default=0)
    args.add_argument('--l2', type=float, default=1e-6)
    args.add_argument('--loss_alpha', type=float, default=0.8)
    args.add_argument('--loss_l2', type=float, default=1.)
    args.add_argument('--multiplier', type=float, default=10)
    args.add_argument('--snr', type=float, default=-15)
    args.add_argument('--max_voices', type=int, default=10)
    args.add_argument('--max_noises', type=int, default=6)
    # the JAX package's additive flags
    args.add_argument('--ckpt_dir', type=str, default='')
    args.add_argument('--resume', type=str2bool, default=False)
    args.add_argument('--ckpt_every_epochs', type=int, default=10)
    args.add_argument('--bank_dtype', type=str, default='float32',
                      choices=['float32', 'bfloat16', 'int8'])
    args.add_argument('--remat', type=str2bool, default=False)
    args.add_argument('--n_devices', type=int, default=0)
    args.add_argument('--bank_shard', type=str2bool, default=False)
    args.add_argument('--stream_chunks', type=int, default=0)
    args.add_argument('--chunk_steps', type=int, default=4)
    args.add_argument('--keras_ckpt', type=str2bool, default=False)
    args.add_argument('--seed', type=int, default=0)
    args.add_argument('--compute_dtype', type=str, default='float32',
                      choices=['float32', 'bfloat16'])
    args.add_argument('--steps_per_call', type=int, default=1)
    args.add_argument('--grad_accum', type=int, default=1)
    args.add_argument('--device', type=str, default=None,
                      help="'cpu', or a CUDA device (default)")
    return args


def to_config(ns) -> Config:
    """The run's Config, field for field as JAX's ``to_config``
    (cli/trainer.py:94-109): eff with v 0, ``model`` the backbone's name
    and ``mse_multiplier`` the label multiplier."""
    cfg = Config(model_type='eff', v=0)
    for f in ('name', 'pretrain', 'n_layers', 'n_dim', 'n_chan', 'n_classes',
              'datapath', 'background_sounds', 'voices', 'labels', 'noises',
              'test_background_sounds', 'test_voices', 'test_labels',
              'n_mels', 'optimizer', 'lr', 'clipvalue', 'epochs',
              'batch_size', 'n_frame', 'steps_per_epoch', 'snr',
              'max_voices', 'max_noises', 'lr_div',
              'ckpt_dir', 'resume', 'ckpt_every_epochs',
              'bank_dtype', 'remat', 'n_devices', 'bank_shard',
              'stream_chunks', 'chunk_steps', 'keras_ckpt',
              'seed', 'compute_dtype', 'steps_per_call', 'grad_accum'):
        setattr(cfg, f, getattr(ns, f))
    cfg.model = ns.model
    cfg.mse_multiplier = ns.multiplier
    return cfg


def refuse_unported(config: Config) -> None:
    """n_chan != 2 (ROADMAP C9), before any data is read.
    ``--compute_dtype bfloat16`` trains: the model computes in it, and its
    checkpoints stay float32."""
    if config.n_chan != 2:
        raise ValueError(
            f'n_chan={config.n_chan}: the density features keep 2 channels '
            'at every n_chan (no channel map), so a model built for '
            f'{config.n_chan} cannot train on them; the JAX trainer fails '
            'its first step the same way (ROADMAP C9). Pass --n_chan 2')


def make_loss_fn(ns):
    """The run's ``(y, out[, module]) -> (loss, {})``: the count + TV loss
    in place of the classification loss (reference: trainer.py:251-253),
    plus the l1/l2 kernel penalty when ``ns.l2`` > 0 (trainer.py:248-250:
    an l1-only run trains unregularized). ``ns`` holds the flags
    ``loss_alpha``, ``loss_l2``, ``l1`` and ``l2``."""
    base = density_loss(alpha=ns.loss_alpha, l2=ns.loss_l2)

    def loss_fn(y, out):
        return base(y, out), {}
    if ns.l2 > 0:
        return apply_kernel_regularizer(loss_fn, l1_l2(ns.l1, ns.l2))
    return loss_fn


def make_dataset(config: Config, training: bool, n_classes: int,
                 device) -> DevicePipeline:
    """The density batches of the training or test spec set (counterpart:
    ``make_dataset``, cli/trainer.py:145-149; reference:
    trainer.py:107-141)."""
    return DevicePipeline(make_banks(config, training, n_classes, device),
                          config, training, device=device,
                          variant='density', n_classes=n_classes)


def main(argv=None) -> str:
    """Train; returns the run name (``--name`` without ``.h5``)."""
    ns = build_args().parse_args(argv)
    config = to_config(ns)
    refuse_unported(config)
    print(config)
    device = resolve_device(ns.device)
    mesh = mesh_for_config(config, device)
    if mesh is not None:
        print(f'data-parallel mesh over {mesh.size} devices'
              + (' (banks sharded)' if config.bank_shard else ''))
        if not mesh.joined:
            return launch.run('challenge_tpu_torch.cli.trainer:train',
                              (ns,), mesh.devices, workdir='.')[0]
    return train(ns, device, mesh)


def train(ns, device=None, mesh=None) -> str:
    """The training run of the parsed flags ``ns`` on ``device``, or as a
    rank of ``mesh`` (default: the mesh this process is a rank of);
    returns the run name."""
    config = to_config(ns)
    mesh = mesh if mesh is not None else current()
    if mesh is not None:
        device = mesh.device
    name = ns.name if ns.name.endswith('.h5') else ns.name + '.h5'

    bundle = get_density_model(config, device=device, seed=config.seed)
    # a mesh, the chunk rotation and gradient accumulation ride the fused
    # step, so they train in banks mode (cli/trainer.py:170-192); under
    # --bank_shard on a mesh the banks are built on the host and each rank
    # takes its block (cli/trainer.py:135-141)
    fused = (mesh is not None or config.stream_chunks >= 2
             or config.grad_accum > 1)
    bank_device = 'cpu' if mesh is not None and config.bank_shard else device
    if fused:
        loop = TrainLoop(
            bundle, seed=config.seed, loss_fn=make_loss_fn(ns),
            variant='density',
            banks=make_banks(config, True, ns.n_classes, bank_device),
            val_banks=make_banks(config, False, ns.n_classes, bank_device),
            mesh=mesh)
    else:
        loop = TrainLoop(bundle, seed=config.seed, loss_fn=make_loss_fn(ns))
    n_params = sum(p.numel() for p in bundle.module.parameters())
    print(f'{type(bundle.module).__name__}: {n_params} parameters')

    if ns.pretrain:
        loop.set_weights(load_weights(name, device, bundle))
        print('loaded pretrained model')
    initial_epoch = resume(config, loop)

    train_set = test_set = None        # banks mode draws from the banks
    if not fused:
        train_set = make_dataset(config, True, ns.n_classes, device)
        test_set = make_dataset(config, False, ns.n_classes, device)
    callbacks = [
        CSVLogger(name.replace('.h5', '.log')),
        SWA(start_epoch=config.epochs // 2, swa_freq=2),
        ModelCheckpoint(name, monitor='val_loss', verbose=1,
                        keras=config.keras_ckpt),
        TerminateOnNaN(),
    ]
    if not ns.pretrain:
        callbacks.append(LearningRateScheduler(
            custom_scheduler(4096, config.epochs / 12, ns.lr_div)))
    else:
        callbacks.append(ReduceLROnPlateau(monitor='loss', factor=0.9,
                                           patience=5))
    if config.ckpt_dir:
        callbacks.append(TrainStateCheckpoint(
            config.ckpt_dir, every_epochs=config.ckpt_every_epochs))
    loop.fit(train_set, epochs=config.epochs,
             steps_per_epoch=config.steps_per_epoch,
             validation_iter=test_set, validation_steps=16,
             callbacks=callbacks, initial_epoch=initial_epoch)
    if is_writer():
        save_weights(name.replace('.h5', '_SWA.h5'),
                     loop.state.module.state_dict(),
                     keras=config.keras_ckpt, bundle=bundle)
    return name[:-len('.h5')]


if __name__ == '__main__':
    main()
