"""The entry points of the repository's root ``__graft_entry__.py`` on the
port.

``entry(device=None)`` is the eval-mode forward of the flagship model (vad
v8, the challenge's main detector) at the reference's training shapes:
batch 12, 80 mels x 512 frames x 2 channels (reference:
sj_train.py:57-59, 220-221).

``dryrun_multichip(n_devices, device=None)`` builds an ``n_devices``-rank
data-parallel mesh (``parallel.launch``) and runs, on every rank, each
multi-device surface of the package on small shapes, with
``__graft_entry__.py``'s configs, sizes, seeds and sources:

1. one fused mesh step (draws, synthesis, features, SpecAugment, the
   model's forward and backward, AGC, Adam, the metrics) of vad v3 on
   replicated float32 banks;
2. the same step with ``remat``, bfloat16 banks, ``bank_shard`` (each
   rank holds its block of the banks' clip axis) and ``grad_accum`` 2;
3. the fused step on int8 banks built on the host and bank-sharded;
4. one se v9 pretrain step on replicated int8 banks: the se triple on a
   rank's share, the U-Net's cross-replica BatchNorm, the freeze mask;
5. a bank rotation of 2 chunks (``build_streaming_banks``) through
   ``TrainLoop.fit`` on the mesh, 2 epochs of 2 steps;
6. ``evaluate(mesh=)`` of that model on two 2 s stereo clips, padded to
   the mesh and scored in blocks of the ranks.

Every rank checks JAX's assertions (a finite loss, the step count, the
history and the ERs), and :func:`dryrun_multichip` checks what one
program over a mesh cannot need checking: every rank's weights and logged
metrics equal bit for bit after each part; and the grids and ERs of part
6 equal the one-process ``evaluate`` of rank 0's weights. A rank that
fails makes the call raise.

The mesh has a rank a card where ``n_devices`` cards are visible (NCCL,
the steps as CUDA graphs); otherwise ``n_devices`` ranks share the card,
or the CPU with ``device='cpu'``, over gloo (``parallel.mesh.Mesh``).
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
import time
import wave

import numpy as np
import torch

from challenge_tpu_torch.config import Config
from challenge_tpu_torch.data.pipeline import build_banks
from challenge_tpu_torch.data.streaming import build_streaming_banks
from challenge_tpu_torch.device import resolve_device
from challenge_tpu_torch.evaluate.infer import batched_grids, evaluate
from challenge_tpu_torch.models.registry import get_model
from challenge_tpu_torch.ops import cuda
from challenge_tpu_torch.parallel import launch
from challenge_tpu_torch.parallel import mesh as mesh_lib
from challenge_tpu_torch.parallel.train import make_fused_train_step
from challenge_tpu_torch.train.loop import TrainLoop
from challenge_tpu_torch.train.state import init_state

ENTRY_CONFIG = Config(model_type='vad', v=8, n_mels=80, n_frame=512,
                      n_chan=2, batch_size=12)
EVAL_HOP = 32
PARTS = ('fused', 'capacity', 'int8', 'se', 'stream', 'eval')


def entry(device=None):
    """``(fn, args)``: ``fn(*args)`` is vad v8's eval-mode forward, ``args``
    its weights and BN statistics (a state_dict) from seed 0 and a
    standard normal input [12, 80, 512, 2] from seed 1, on ``device``
    (default ``cuda``)."""
    device = resolve_device(device)
    cfg = ENTRY_CONFIG
    bundle = get_model(cfg, device, seed=0)
    module = bundle.module
    variables = {k: v.detach() for k, v in module.state_dict().items()}
    x = torch.randn((cfg.batch_size,) + bundle.input_shape,
                    generator=torch.Generator().manual_seed(1)).to(device)

    def fn(variables, x):
        module.eval()
        with torch.no_grad():
            return torch.func.functional_call(module, variables, (x,))

    return fn, (variables, x)


def _sources(rng: np.random.Generator, n_bg: int = 3, n_voice: int = 4,
             n_noise: int = 3, abs_voices: bool = False):
    """``__graft_entry__.py``'s spec sources, drawn in its order:
    backgrounds [257, 94, 4], voices [257, 40, 4], class ids in [0, 3),
    noises [257, 20, 4]."""
    bg = [rng.standard_normal((257, 94, 4)).astype('f4')
          for _ in range(n_bg)]
    voices = [rng.standard_normal((257, 40, 4)).astype('f4')
              for _ in range(n_voice)]
    if abs_voices:
        voices = [np.abs(v) for v in voices]
    labels = rng.integers(0, 3, size=n_voice)
    noises = [rng.standard_normal((257, 20, 4)).astype('f4')
              for _ in range(n_noise)]
    return bg, voices, labels, noises


def _vad_config(n: int) -> Config:
    """The vad v3 configuration of the parts on an ``n``-rank mesh."""
    return Config(model_type='vad', v=3, n_mels=80, n_frame=64, n_chan=2,
                  batch_size=2 * n)


def _gen(device, key: int, rank: int) -> torch.Generator:
    """The step's generator of ``key``, the rank folded in (JAX: the key
    folded with ``axis_index``)."""
    seed = int(np.random.SeedSequence([key, rank]).generate_state(1)[0])
    return torch.Generator(device=device).manual_seed(seed)


def digest(module: torch.nn.Module) -> str:
    """A hash of every byte of ``module``'s weights and BN statistics."""
    h = hashlib.sha256()
    for k, v in module.state_dict().items():
        h.update(k.encode())
        h.update(v.detach().cpu().contiguous().view(torch.uint8).numpy()
                 .tobytes())
    return h.hexdigest()


def _floats(metrics: dict) -> dict:
    return {k: np.asarray(v.detach().cpu() if torch.is_tensor(v) else v,
                          np.float64).tolist()
            for k, v in metrics.items()}


def _finite_loss(part: str, metrics: dict) -> None:
    if not np.isfinite(metrics['loss']):
        raise AssertionError(f'dryrun {part}: loss {metrics}')


def _fused_step(bundle, config, mesh, banks, key: int,
                bank_sharded: bool = False) -> dict:
    """One fused mesh step from seed-0 weights, rank 0's on every rank."""
    state = init_state(bundle, 0)
    mesh_lib.replicate(state.module, mesh)
    step = make_fused_train_step(bundle, config, mesh=mesh,
                                 bank_sharded=bank_sharded)
    metrics = _floats(step(state, banks, _gen(mesh.device, key, mesh.rank)))
    if state.step != 1:
        raise AssertionError(f'dryrun: step {state.step} after one step')
    return {'metrics': metrics, 'digest': digest(state.module)}


def rank_body(eval_dir: str) -> dict:
    """What each rank of :func:`dryrun_multichip` runs (the module
    docstring's parts 1-6). Returns, for each part, the launches of each
    kernel, the seconds, the metrics and the weights' digest; rank 0 also
    returns part 5's weights."""
    mesh = mesh_lib.current()
    n, dev = mesh.size, mesh.device
    out = {'rank': mesh.rank, 'backend': mesh.backend, 'parts': {}}

    def run(part: str, fn) -> dict:
        cuda.reset_launch_counts()
        t0 = time.perf_counter()
        res = fn()
        if dev.type == 'cuda':
            torch.cuda.synchronize(dev)
        res.update(launches=dict(cuda.LAUNCHES),
                   seconds=time.perf_counter() - t0)
        out['parts'][part] = res
        return res

    cfg = _vad_config(n)
    bundle = get_model(cfg, dev)

    # 1. the fused mesh step on replicated float32 banks
    def fused():
        banks = build_banks(*_sources(np.random.default_rng(0)),
                            n_frame=cfg.n_frame, device=dev)
        return _fused_step(bundle, cfg, mesh, banks, 1)
    _finite_loss('fused', run('fused', fused)['metrics'])

    # 2. remat + bfloat16 banks + bank_shard + grad_accum 2, the banks
    # built on the host and each rank's block placed by shard_banks
    cfg2 = cfg.replace(remat=True, bank_dtype='bfloat16', bank_shard=True,
                       grad_accum=2)

    def capacity():
        banks = build_banks(*_sources(np.random.default_rng(1)),
                            n_frame=cfg2.n_frame,
                            flat_dtype=cfg2.bank_dtype, device='cpu')
        return _fused_step(get_model(cfg2, dev), cfg2, mesh,
                           mesh_lib.shard_banks(banks, mesh), 2,
                           bank_sharded=True)
    _finite_loss('capacity', run('capacity', capacity)['metrics'])

    # 3. int8 banks, host-built, bank-sharded
    def int8():
        banks = build_banks(*_sources(np.random.default_rng(7)),
                            n_frame=cfg.n_frame, flat_dtype='int8',
                            device='cpu')
        return _fused_step(bundle, cfg, mesh,
                           mesh_lib.shard_banks(banks, mesh), 5,
                           bank_sharded=True)
    _finite_loss('int8', run('int8', int8)['metrics'])

    # 4. se v9 pretrain on replicated int8 banks, max(n, 2) samples
    cfg5 = Config(model_type='se', v=9, n_frame=64, n_chan=2,
                  batch_size=max(n, 2), pretrain=True)

    def se():
        banks = build_banks(*_sources(np.random.default_rng(9),
                                      abs_voices=True),
                            n_frame=cfg5.n_frame, flat_dtype='int8',
                            device=dev)
        return _fused_step(get_model(cfg5, dev), cfg5, mesh, banks, 6)
    _finite_loss('se', run('se', se)['metrics'])

    # 5. bank rotation through TrainLoop.fit on the mesh; class ids in
    # the reference's c*10 convention, since remap_labels floor-divides
    # by 10 (raw ids 0-2 would all become class 0)
    cfg3 = cfg.replace(stream_chunks=2, chunk_steps=1)
    bundle3 = get_model(cfg3, dev)

    def stream():
        bg, voices, labels, noises = _sources(
            np.random.default_rng(2), n_bg=4, n_voice=6, n_noise=4)
        banks = build_streaming_banks(bg, voices, labels * 10, noises,
                                      n_chunks=2, n_frame=cfg3.n_frame,
                                      chunk_steps=1, device=dev)
        loop = TrainLoop(bundle3, banks=banks, mesh=mesh)
        hist = loop.fit(epochs=2, steps_per_epoch=2, verbose=0)
        if len(hist) != 2 or not np.isfinite(hist[-1]['loss']):
            raise AssertionError(f'dryrun stream: history {hist}')
        return {'metrics': [{k: v for k, v in h.items() if k != 'time'}
                            for h in hist],
                'digest': digest(bundle3.module)}
    run('stream', stream)
    if mesh.rank == 0:
        out['weights'] = {k: v.detach().cpu().clone()
                          for k, v in bundle3.module.state_dict().items()}

    # 6. the mesh-sharded challenge eval of that model
    def eval_():
        ers = evaluate(cfg3, bundle3.module, overlap_hop=EVAL_HOP,
                       eval_dir=eval_dir, mesh=mesh)
        if len(ers) != 2 or not all(np.isfinite(e) for e in ers):
            raise AssertionError(f'dryrun eval: ERs {ers}')
        grids = batched_grids(cfg3, bundle3.module, _wavs(eval_dir),
                              EVAL_HOP, mesh=mesh)
        return {'metrics': {'ers': ers}, 'grids': grids,
                'digest': hashlib.sha256(b''.join(
                    np.ascontiguousarray(g).tobytes() for g in grids))
                .hexdigest()}
    run('eval', eval_)
    if mesh.rank != 0:
        out['parts']['eval'].pop('grids')
    return out


def _wavs(d: str) -> list:
    return sorted(os.path.join(d, p) for p in os.listdir(d)
                  if p.endswith('.wav'))


def write_eval_set(d: str) -> None:
    """``__graft_entry__.py``'s dev set in ``d``: two 2 s stereo 16 kHz
    clips of Gaussian PCM from seed 3, each with one event of class 0
    from 0.2 to 0.6 s in ``sample_answer.json``."""
    rng = np.random.default_rng(3)
    answer = {}
    for i in range(2):
        stem = f'clip{i:02d}'
        pcm = (rng.standard_normal((2 * 16000, 2)) * 3000).astype(np.int16)
        with wave.open(os.path.join(d, f'{stem}.wav'), 'wb') as f:
            f.setnchannels(2)
            f.setsampwidth(2)
            f.setframerate(16000)
            f.writeframes(pcm.tobytes())
        answer[stem] = [[0, 0.2, 0.6]]
    with open(os.path.join(d, 'sample_answer.json'), 'w') as f:
        json.dump({'task2_answer': answer}, f)


def _rank_devices(n_devices: int, device: torch.device) -> list:
    """A card a rank where ``n_devices`` are visible, else every rank on
    ``device``."""
    if device.type == 'cuda' and torch.cuda.device_count() >= n_devices:
        return [torch.device('cuda', i) for i in range(n_devices)]
    return [device] * n_devices


def _check_ranks(ranks: list) -> None:
    """Every rank's weights and metrics equal rank 0's after each part."""
    for part in PARTS:
        r0 = ranks[0]['parts'][part]
        for r in ranks[1:]:
            got = r['parts'][part]
            if got['digest'] != r0['digest']:
                raise AssertionError(f'dryrun {part}: rank {r["rank"]}\'s '
                                     'state differs from rank 0\'s')
            if got['metrics'] != r0['metrics']:
                raise AssertionError(
                    f'dryrun {part}: rank {r["rank"]} logs '
                    f'{got["metrics"]}, rank 0 {r0["metrics"]}')


def _check_eval(ranks: list, eval_dir: str, device) -> None:
    """Part 6 over the mesh against the one-process eval of rank 0's
    weights: the ERs and the grids equal."""
    cfg = _vad_config(len(ranks)).replace(stream_chunks=2, chunk_steps=1)
    module = get_model(cfg, device).module
    module.load_state_dict(ranks[0]['weights'])
    ers = evaluate(cfg, module, overlap_hop=EVAL_HOP, eval_dir=eval_dir)
    grids = batched_grids(cfg, module, _wavs(eval_dir), EVAL_HOP)
    got = ranks[0]['parts']['eval']
    if got['metrics']['ers'] != ers:
        raise AssertionError(f'dryrun eval: ERs {got["metrics"]["ers"]} '
                             f'over the mesh, {ers} in one process')
    if len(got['grids']) != len(grids) or not all(
            np.array_equal(a, b) for a, b in zip(got['grids'], grids)):
        raise AssertionError('dryrun eval: the mesh\'s grids differ from '
                             'the one-process grids')


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """Run the module docstring's parts on an ``n_devices``-rank mesh;
    raise where a rank fails or a check does not hold. ``device``:
    ``cuda`` by default (kernels built before the ranks start), ``'cpu'``
    for a mesh of CPU processes. Returns a report: the ranks, the backend,
    each rank's launches and seconds a part, and the ERs."""
    device = resolve_device(device)
    devices = _rank_devices(n_devices, device)
    if device.type == 'cuda':
        cuda.build(['synth'])     # once, before the ranks load it
    with tempfile.TemporaryDirectory(prefix='dryrun_eval_') as d:
        write_eval_set(d)
        ranks = launch.run('challenge_tpu_torch.dryrun:rank_body', (d,),
                           devices, workdir=d)
        _check_ranks(ranks)
        _check_eval(ranks, d, devices[0])
    return {'ranks': len(ranks), 'backend': ranks[0]['backend'],
            'devices': [str(x) for x in devices],
            'launches': [{p: r['parts'][p]['launches'] for p in PARTS}
                         for r in ranks],
            'seconds': {p: [r['parts'][p]['seconds'] for r in ranks]
                        for p in PARTS},
            'metrics': {p: ranks[0]['parts'][p]['metrics'] for p in PARTS}}
