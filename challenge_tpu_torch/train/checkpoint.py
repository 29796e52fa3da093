"""Weight checkpoints (counterpart: ``challenge_tpu/train/checkpoint.py``).

The reference's three-file convention stays: ``{run}.h5`` (best),
``{run}_SWA.h5`` and ``{run}_sample.h5`` (reference: sj_train.py:492,521;
metrics.py:28). The port writes them as ``torch.save`` of the module's
``state_dict`` under those names, so the run-name grammar stays
round-trippable; the ``.h5`` name does not make them HDF5.

It does not read or write flax msgpack: a JAX-written checkpoint is decoded
with ``flax.serialization.msgpack_restore`` where flax is installed and
bridged with ``interop.jax_weights.flax_to_state_dict``. Keras HDF5 files
and the full train-state resume wait for ROADMAP A15.
"""

from __future__ import annotations

import os

import torch

_HDF5_MAGIC = b'\x89HDF\r\n\x1a\n'


def save_weights(path: str, state_dict, keras: bool = False) -> None:
    """Write ``state_dict`` (CPU copies of its tensors) to ``path`` through a
    temporary file and ``os.replace``, so a crash never leaves a torn
    checkpoint under the final name."""
    if keras:
        raise NotImplementedError(
            'Keras HDF5 checkpoints are not ported yet (ROADMAP A15)')
    tmp = path + '.tmp'
    torch.save({k: v.detach().cpu() for k, v in state_dict.items()}, tmp)
    os.replace(tmp, path)


def load_weights(path: str, device=None) -> dict:
    """The ``state_dict`` saved by :func:`save_weights`, its tensors on
    ``device`` (default: the CPU)."""
    with open(path, 'rb') as f:
        if f.read(8) == _HDF5_MAGIC:
            raise NotImplementedError(
                f'{path!r} is a Keras HDF5 checkpoint; reading those is not '
                'ported yet (ROADMAP A15)')
    return torch.load(path, map_location=device or 'cpu', weights_only=True)

