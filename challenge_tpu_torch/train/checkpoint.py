"""Weight checkpoints (counterpart: ``challenge_tpu/train/checkpoint.py``).

The reference's three-file convention stays: ``{run}.h5`` (best),
``{run}_SWA.h5`` and ``{run}_sample.h5`` (reference: sj_train.py:492,521;
metrics.py:28). The port writes them as ``torch.save`` of the module's
``state_dict`` under those names, so the run-name grammar stays
round-trippable; the ``.h5`` name does not make them HDF5.

With ``keras=True`` (``--keras_ckpt``) they are real Keras-2 legacy HDF5
files instead, which the reference's ``model.load_weights`` and the JAX
package read (``interop.keras_h5``); :func:`load_weights` tells the two
formats apart by the HDF5 magic. It does not read or write flax msgpack: a
JAX-written msgpack checkpoint is decoded with
``flax.serialization.msgpack_restore`` where flax is installed and bridged
with ``interop.jax_weights.flax_to_state_dict``.

The full train state (``--ckpt_dir``, ``--resume``; counterpart:
``save_train_state``, ``checkpoint_steps``, ``restore_train_state``,
checkpoint.py:70-126) is one ``torch.save`` file under
``ckpt_dir/<step>/``: the module's weights and BN statistics, each
optimizer group's device ``lr`` and ``step``, every optimizer slot, the
SWA average and count, and the step. The last ``max_to_keep`` steps are
kept. A restore copies into the live tensors, so every address a captured
step reads holds. Neither package reads the other's full-state
checkpoints (JAX's are Orbax directories).
"""

from __future__ import annotations

import os
import shutil

import torch

_HDF5_MAGIC = b'\x89HDF\r\n\x1a\n'


def save_weights(path: str, state_dict, keras: bool = False,
                 bundle=None) -> None:
    """Write ``state_dict`` (CPU copies of its tensors) to ``path`` through a
    temporary file and ``os.replace``, so a crash never leaves a torn
    checkpoint under the final name: ``torch.save``, or with ``keras=True``
    a Keras HDF5 file of ``bundle``'s (the ModelBundle's) layers."""
    tmp = path + '.tmp'
    if keras:
        if bundle is None:
            raise ValueError('keras=True export needs the model bundle')
        from challenge_tpu_torch.interop.keras_h5 import (
            save_keras_h5_state_dict)
        save_keras_h5_state_dict(bundle, state_dict, tmp)
    else:
        torch.save({k: v.detach().cpu() for k, v in state_dict.items()},
                   tmp)
    os.replace(tmp, path)


def load_weights(path: str, device=None, bundle=None) -> dict:
    """The ``state_dict`` saved by :func:`save_weights`, its tensors on
    ``device`` (default: the CPU). A Keras HDF5 file (told by its magic
    bytes) goes through the Keras importer, which needs ``bundle``, the
    ModelBundle it is read for."""
    with open(path, 'rb') as f:
        if f.read(8) == _HDF5_MAGIC:
            if bundle is None:
                raise ValueError(
                    f'{path!r} is a Keras HDF5 checkpoint; pass the model '
                    'bundle so it can be imported '
                    '(challenge_tpu_torch.interop.keras_h5)')
            from challenge_tpu_torch.interop.keras_h5 import (
                load_keras_h5_state_dict)
            return {k: v.to(device or 'cpu') for k, v in
                    load_keras_h5_state_dict(bundle, path).items()}
    return torch.load(path, map_location=device or 'cpu', weights_only=True)


# ----------------------------------------------------------- full train state
TRAIN_STATE_FILE = 'train_state.pt'


def _slots(state):
    """(name, parameter, slot) for each optimizer slot of ``state``."""
    names = {id(p): n for n, p in state.module.named_parameters()}
    for group in state.optimizer.param_groups:
        for p in group['params']:
            for slot in state.optimizer.slot_names():
                yield f'slot/{names[id(p)]}/{slot}', p, slot


def train_state_tensors(state) -> dict:
    """The tensors a full-state checkpoint holds, by name: the live tensors
    of ``state`` themselves (the module's state_dict, each optimizer
    group's device ``lr`` and ``step``, each parameter's optimizer slots,
    the SWA average), or None for a slot the step has not made yet."""
    optimizer = state.optimizer
    out = {f'module/{k}': v for k, v in state.module.state_dict().items()}
    for i, group in enumerate(optimizer.param_groups):
        for k in ('lr', 'step'):
            if torch.is_tensor(group.get(k)):
                out[f'optimizer/{i}/{k}'] = group[k]
    for key, p, slot in _slots(state):
        out[key] = optimizer.state[p].get(slot)
    out.update({f'swa/{k}': v for k, v in (state.swa or {}).items()})
    return out


def checkpoint_steps(ckpt_dir: str):
    """Steps with a retained checkpoint, ascending."""
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(d) for d in os.listdir(ckpt_dir) if d.isdigit()
                  and os.path.exists(os.path.join(ckpt_dir, d,
                                                  TRAIN_STATE_FILE)))


def save_train_state(ckpt_dir: str, state, step: int = None,
                     max_to_keep: int = 3) -> None:
    """Write the full train state under ``ckpt_dir/<step>`` (``step``
    defaults to ``state.step``) through a temporary directory and
    ``os.replace``, then keep the last ``max_to_keep`` steps. As Orbax's
    manager does, a step at or below the latest retained one is skipped. A
    slot the optimizer has not made yet is saved as the zeros it starts
    from."""
    step = int(state.step) if step is None else int(step)
    steps = checkpoint_steps(ckpt_dir)
    if steps and steps[-1] >= step:
        return
    tensors = {}
    params = {k: p for k, p, _ in _slots(state)}
    for k, v in train_state_tensors(state).items():
        if v is None:
            v = torch.zeros(params[k].shape, dtype=params[k].dtype)
        tensors[k] = v.detach().cpu()
    final = os.path.join(ckpt_dir, str(step))
    tmp = final + '.tmp'
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save({'tensors': tensors, 'step': step,
                'swa_count': int(state.swa_count)},
               os.path.join(tmp, TRAIN_STATE_FILE))
    shutil.rmtree(final, ignore_errors=True)   # a torn write's leftovers
    os.replace(tmp, final)
    for old in (steps + [step])[:-max_to_keep]:
        shutil.rmtree(os.path.join(ckpt_dir, str(old)), ignore_errors=True)


def restore_train_state(ckpt_dir: str, target, step: int = None):
    """Restore the checkpoint at ``step`` (default: the latest retained)
    into ``target``, a TrainState, in place, and return it. Every tensor is
    copied into the live one (a slot the optimizer has not made yet is
    first made as the step makes it), so the module's weights, the
    optimizer's ``lr``, ``step`` and slots and the SWA buffers keep their
    addresses, and a captured step stays valid. No checkpoint raises
    ``FileNotFoundError``; one whose names, shapes or dtypes differ from
    the live state raises ``ValueError`` before anything is copied."""
    steps = checkpoint_steps(ckpt_dir)
    if step is None:
        step = steps[-1] if steps else None
    if step is None or step not in steps:
        raise FileNotFoundError(f'no checkpoints under {ckpt_dir}'
                                + ('' if step is None else f' at step {step}'))
    saved = torch.load(os.path.join(ckpt_dir, str(step), TRAIN_STATE_FILE),
                       map_location='cpu', weights_only=True)
    tensors = saved['tensors']
    live = train_state_tensors(target)
    slots = {k: (p, slot) for k, p, slot in _slots(target)}

    def spec(k, v):
        if v is None:
            v = slots[k][0]
        return tuple(v.shape), v.dtype

    problems = sorted(set(live) ^ set(tensors))
    problems += [f'{k}: saved {tuple(tensors[k].shape)} {tensors[k].dtype}, '
                 f'live {spec(k, v)[0]} {spec(k, v)[1]}'
                 for k, v in live.items() if k in tensors
                 and spec(k, v) != (tuple(tensors[k].shape), tensors[k].dtype)]
    if problems:
        raise ValueError(
            f'checkpoint at {ckpt_dir!r} step {step} does not match the '
            'current train-state structure (saved with a different '
            f'model/optimizer version?): {problems[:8]}')
    with torch.no_grad():
        for k, v in live.items():
            if v is None:
                p, slot = slots[k]
                v = target.optimizer.state[p][slot] = torch.zeros_like(p)
            v.copy_(tensors[k])
    target.step = int(saved['step'])
    target.swa_count = int(saved['swa_count'])
    return target
