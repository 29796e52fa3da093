"""The data-parallel mesh (counterpart: ``challenge_tpu/parallel/mesh.py``).

JAX's mesh is one program over a 1-D ``jax.sharding.Mesh``: the batch is
split over the devices and XLA inserts the gradient all-reduce. The port
runs one process per device, a *rank*, joined by ``torch.distributed``:
``nccl`` across distinct cards, ``gloo`` on the CPU and where ranks share a
card. Each rank runs the step on its share of the batch; the collectives
(``models.layers.BatchNorm``'s cross-replica statistics, the gradient and
metric all-reduces of ``parallel.train``) keep the ranks identical.
``parallel.launch`` starts the ranks.

NCCL's collectives can be captured in a CUDA graph, gloo's cannot
(:attr:`Mesh.capturable`): on an NCCL mesh the steps run as CUDA graphs
(``train.graph``), on a gloo mesh eagerly. The collectives a step issues
(:meth:`Mesh.all_reduce_`, :meth:`Mesh.broadcast_`) stay on the device
with no host sync, so they can be captured; :meth:`Mesh.all_gather` and
:meth:`Mesh.broadcast_object` go through the host and serve only the
eval and the callbacks, outside any step.

A :class:`Mesh` is first a plan (its devices, one per rank); the process
that joins it as a rank (:func:`join`) holds it, with its rank and process
group, as the process's :func:`current` mesh. On the CPU a mesh of k ranks
is k CPU processes; the device policy counts one CPU device, so a caller
asks for such a mesh with :func:`make_mesh`.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from challenge_tpu_torch.data.mixture import Banks

# how long a rank waits on its peers (rendezvous, any collective) before it
# raises: no rank hangs on a dead peer
TIMEOUT = datetime.timedelta(minutes=10)

_current: Optional['Mesh'] = None


@dataclasses.dataclass
class Mesh:
    """A 1-D data-parallel mesh: rank r runs on ``devices[r]``. ``rank``
    and ``group`` are set in the process that joined it."""
    devices: Tuple[torch.device, ...]
    rank: Optional[int] = None
    group: Any = None

    def __post_init__(self):
        self.devices = tuple(torch.device(d) for d in self.devices)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def joined(self) -> bool:
        return self.group is not None

    @property
    def device(self) -> torch.device:
        """This rank's device."""
        return self.devices[self.rank]

    @property
    def backend(self) -> str:
        """``nccl`` when every rank has a card of its own, else ``gloo``."""
        cuda = all(d.type == 'cuda' for d in self.devices)
        distinct = len({d.index for d in self.devices}) == self.size
        return 'nccl' if cuda and distinct else 'gloo'

    @property
    def capturable(self) -> bool:
        """Whether this rank's collectives can be captured in a CUDA graph:
        joined, over NCCL, on a card."""
        return (self.joined and self.backend == 'nccl'
                and self.device.type == 'cuda')

    # --------------------------------------------------------- collectives
    def _flat(self, tensors: Sequence[torch.Tensor], collective) -> None:
        """``collective`` on each dtype's tensors flattened into one
        buffer, the result copied back into them."""
        by_dtype = {}
        for t in tensors:
            by_dtype.setdefault(t.dtype, []).append(t)
        for group in by_dtype.values():
            flat = torch.cat([t.reshape(-1) for t in group])
            collective(flat)
            offset = 0
            for t in group:
                t.copy_(flat[offset:offset + t.numel()].view_as(t))
                offset += t.numel()

    def all_reduce_(self, tensors: Sequence[torch.Tensor]) -> None:
        """Sum each tensor over the ranks, in place."""
        import torch.distributed as dist
        self._flat(tensors, lambda f: dist.all_reduce(f, group=self.group))

    def broadcast_(self, tensors: Sequence[torch.Tensor],
                   src: int = 0) -> None:
        """Copy rank ``src``'s tensors into every rank's, in place."""
        import torch.distributed as dist
        self._flat(tensors,
                   lambda f: dist.broadcast(f, src, group=self.group))

    def all_gather(self, tensor: torch.Tensor) -> torch.Tensor:
        """Every rank's ``tensor`` (equal shapes), concatenated on the
        leading axis in rank order, on the tensor's device (gloo reduces
        and broadcasts CUDA tensors, but gathers only host ones)."""
        import torch.distributed as dist
        host = self.backend == 'gloo' and tensor.is_cuda
        src = tensor.cpu() if host else tensor.contiguous()
        out = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(out, src, group=self.group)
        return torch.cat(out).to(tensor.device)

    def broadcast_object(self, obj, src: int = 0):
        """Rank ``src``'s picklable ``obj``, on every rank."""
        import torch.distributed as dist
        box = [obj]
        dist.broadcast_object_list(box, src, group=self.group)
        return box[0]


def current() -> Optional[Mesh]:
    """The mesh this process is a rank of, or None."""
    return _current


def is_writer() -> bool:
    """Whether this process writes the run's files: it is no rank, or rank
    0. Every rank takes the same decisions; only one writes them down."""
    return _current is None or _current.rank == 0


def join(mesh: Mesh, rank: int, init_method: str) -> Mesh:
    """Join ``mesh`` as ``rank`` through the rendezvous ``init_method``
    (``file://...``, or ``env://`` under torchrun); it becomes this
    process's :func:`current` mesh. A peer that does not arrive, or a
    collective that does not end, within :data:`TIMEOUT` raises."""
    import torch.distributed as dist
    global _current
    if _current is not None:
        raise RuntimeError('this process is a rank of a mesh already')
    mesh = Mesh(mesh.devices, rank)
    if mesh.device.type == 'cuda':
        torch.cuda.set_device(mesh.device)
    dist.init_process_group(mesh.backend, init_method=init_method,
                            rank=rank, world_size=mesh.size,
                            timeout=TIMEOUT)
    mesh.group = dist.group.WORLD
    if mesh.backend == 'nccl':
        # NCCL makes its communicator and stream at the first collective,
        # which must not fall inside a graph capture: make them here.
        # Capturing NCCL's collectives needs no other setting on PyTorch
        # 2.11 with NCCL 2.28 (async error handling stays on)
        dist.all_reduce(torch.zeros(1, device=mesh.device), group=mesh.group)
        torch.cuda.synchronize(mesh.device)
    _current = mesh
    return mesh


def leave() -> None:
    """Leave the current mesh (destroys the process group)."""
    import torch.distributed as dist
    global _current
    if _current is not None:
        _current = None
        dist.destroy_process_group()


def device_count(device: torch.device) -> int:
    """The devices a run on ``device`` can see: CUDA's count for a CUDA
    device, 1 for the CPU."""
    return torch.cuda.device_count() if device.type == 'cuda' else 1


def _rank_devices(n: int, device: torch.device) -> List[torch.device]:
    if device.type == 'cuda':
        return [torch.device('cuda', i) for i in range(n)]
    return [device] * n


def make_mesh(n_devices: int = 0, devices=None) -> Mesh:
    """A mesh over the first ``n_devices`` of ``devices`` (0: all of them;
    default: every visible card, or the CPU). Inside a rank, the mesh it
    joined, which must have that size. ``devices`` may repeat a device: a
    CPU mesh of k ranks is ``make_mesh(k, ['cpu'] * k)``."""
    if _current is not None:
        if n_devices and n_devices != _current.size:
            raise ValueError(f'this process is a rank of a mesh of '
                             f'{_current.size}, not {n_devices}')
        return _current
    if devices is None:
        devices = (_rank_devices(torch.cuda.device_count(),
                                 torch.device('cuda'))
                   if torch.cuda.is_available() else ['cpu'])
    devices = list(devices)
    if n_devices and n_devices > 0:
        devices = devices[:n_devices]
    return Mesh(tuple(devices))


def _torchrun_world() -> int:
    return int(os.environ.get('WORLD_SIZE', '1')) if \
        'TORCHELASTIC_RUN_ID' in os.environ else 1


def mesh_for_config(config, device: torch.device) -> Optional[Mesh]:
    """The training CLIs' device policy, JAX's ``mesh_for_config`` with its
    messages and ``ValueError``s: a mesh over ``config.n_devices`` devices
    (0: all visible) when more than one is visible and the global batch
    divides them, else None (single-device). A rank counts its mesh's
    ranks as the visible devices, and gets that mesh back; a process that
    ``torchrun`` started joins its ranks here (``env://``)."""
    world = _current.size if _current is not None else _torchrun_world()
    avail = world if world > 1 else device_count(device)
    n = config.n_devices if config.n_devices > 0 else avail
    n = min(n, avail)
    bank_shard = bool(getattr(config, 'bank_shard', False))
    mesh = None
    if n <= 1:
        if bank_shard and avail > 1:
            raise ValueError(
                'bank_shard needs a multi-device mesh but n_devices caps it '
                f'at {n}; raise --n_devices (devices available: {avail})')
        if bank_shard:
            print('bank_shard has no effect on a single device: the full '
                  'banks stay resident (use --stream_chunks for datasets '
                  'larger than HBM)', flush=True)
    elif config.batch_size % n != 0:
        if bank_shard:
            raise ValueError(
                f'bank_shard requires a multi-device mesh, but batch_size '
                f'{config.batch_size} does not divide the {n} devices — '
                'pick a divisible batch (or drop --bank_shard)')
        print(f'batch_size {config.batch_size} does not divide {n} devices;'
              ' training single-device (pick a divisible batch to scale)',
              flush=True)
    else:
        mesh = make_mesh(n, _rank_devices(n, device))
    if world > 1 and (mesh is None or mesh.size != world):
        raise ValueError(
            f'{world} ranks were started, but the device policy trains on '
            f'{1 if mesh is None else mesh.size} (--n_devices '
            f'{config.n_devices}, batch_size {config.batch_size})')
    if mesh is not None and _current is None and world > 1:
        local = int(os.environ.get('LOCAL_WORLD_SIZE', world))
        devices = ([torch.device('cuda', r % local) for r in range(world)]
                   if device.type == 'cuda' else mesh.devices)
        mesh = join(Mesh(devices), int(os.environ['RANK']), 'env://')
    return mesh


# ------------------------------------------------------------ placement
def _pad_leading_cyclic(tensors, n: int):
    """Pad each tensor's leading axis (all of one length N) to a multiple
    of ``n`` by repeating items cyclically: index i holds item i % N."""
    n_items = tensors[0].shape[0]
    n_pad = -(-n_items // n) * n
    if n_pad == n_items:
        return list(tensors)
    idx = torch.from_numpy(np.arange(n_pad) % n_items)
    return [None if t is None else t[idx.to(t.device)] for t in tensors]


def _bank_block(bank, mesh: Mesh, extra=()):
    """Rank ``mesh.rank``'s block of the clip axis of ``bank`` (and of the
    item-aligned tensors ``extra``), padded cyclically to the mesh, on the
    rank's device."""
    fields = [bank.flat, bank.lens, bank.pos_mask, bank.flat_scale]
    padded = _pad_leading_cyclic([*fields, *extra], mesh.size)
    per = padded[0].shape[0] // mesh.size
    lo = mesh.rank * per
    block = [None if t is None else t[lo:lo + per].to(mesh.device)
             for t in padded]
    flat, lens, pos_mask, flat_scale = block[:4]
    return dataclasses.replace(bank, flat=flat, lens=lens, pos_mask=pos_mask,
                               flat_scale=flat_scale), block[4:]


def shard_banks(banks: Banks, mesh: Mesh) -> Banks:
    """This rank's block of the banks' clip axis (JAX's ``shard_banks``):
    each bank padded cyclically to a multiple of the mesh size, the voices
    together with their labels and an int8 bank with its scales, then
    block ``rank`` of it copied to the rank's device. Built on the host
    (``device='cpu'``), as the CLIs build them under ``--bank_shard``, the
    banks never reach the card whole, so the dataset the mesh holds grows
    with its size. Each rank draws its batch from its own block."""
    bg, _ = _bank_block(banks.backgrounds, mesh)
    voices, (labels,) = _bank_block(banks.voices, mesh,
                                    (banks.voice_labels,))
    noises = (_bank_block(banks.noises, mesh)[0]
              if banks.noises is not None else None)
    return Banks(bg, voices, labels, noises)


def shard_batch(batch, mesh: Mesh):
    """This rank's block of the leading axis of every tensor of ``batch``
    (a tensor or nested tuples/lists of them), on the rank's device."""
    if isinstance(batch, (tuple, list)):
        return type(batch)(shard_batch(b, mesh) for b in batch)
    per = batch.shape[0] // mesh.size
    if per * mesh.size != batch.shape[0]:
        raise ValueError(f'a batch of {batch.shape[0]} does not divide the '
                         f'{mesh.size} ranks')
    return batch[mesh.rank * per:(mesh.rank + 1) * per].to(mesh.device)


def replicate(module: torch.nn.Module, mesh: Mesh) -> None:
    """Rank 0's weights and BN statistics in every rank's ``module``, in
    place."""
    mesh.broadcast_(list(module.state_dict().values()))
