"""The training CLIs' device policy (counterpart:
``challenge_tpu/parallel/mesh.py``, ``mesh_for_config``).

JAX builds a data-parallel mesh over ``min(n_devices or all, visible)``
devices when more than one is available and the global batch divides
them, and trains single-device otherwise. The port counts CUDA devices
the same way (one for a CPU run) and keeps JAX's single-device cases and
messages; the data-parallel mesh itself is not ported yet (ROADMAP A14),
so the case that would build one raises.
"""

from __future__ import annotations

import torch


def device_count(device: torch.device) -> int:
    """The devices a run on ``device`` can see: CUDA's count for a CUDA
    device, 1 for the CPU."""
    return torch.cuda.device_count() if device.type == 'cuda' else 1


def devices_for_config(config, device: torch.device) -> int:
    """The number of devices ``config`` trains on: 1 (single-device), as
    JAX's ``mesh_for_config`` returns no mesh, with its messages and its
    ``ValueError`` for a ``bank_shard`` that cannot shard. Where JAX would
    build a data-parallel mesh (more than one device, a batch they divide)
    it raises ``NotImplementedError``."""
    avail = device_count(device)
    n = config.n_devices if config.n_devices > 0 else avail
    n = min(n, avail)
    bank_shard = bool(getattr(config, 'bank_shard', False))
    if n <= 1:
        if bank_shard and avail > 1:
            raise ValueError(
                'bank_shard needs a multi-device mesh but n_devices caps it '
                f'at {n}; raise --n_devices (devices available: {avail})')
        if bank_shard:
            print('bank_shard has no effect on a single device: the full '
                  'banks stay resident (use --stream_chunks for datasets '
                  'larger than HBM)', flush=True)
        return 1
    if config.batch_size % n != 0:
        if bank_shard:
            raise ValueError(
                f'bank_shard requires a multi-device mesh, but batch_size '
                f'{config.batch_size} does not divide the {n} devices — '
                'pick a divisible batch (or drop --bank_shard)')
        print(f'batch_size {config.batch_size} does not divide {n} devices;'
              ' training single-device (pick a divisible batch to scale)',
              flush=True)
        return 1
    sharded = ' with sharded banks (--bank_shard)' if bank_shard else ''
    raise NotImplementedError(
        f'a data-parallel mesh over {n} devices{sharded} (--n_devices '
        f'{config.n_devices}, batch_size {config.batch_size}) is not ported '
        'yet (ROADMAP A14)')
