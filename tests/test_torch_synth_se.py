"""The se triple of the port (challenge_tpu_torch/ops/synth.py
``synthesize_se``, kernel mode B2 with three accumulators): the full mix,
only_noise and only_voice of one launch.

On the CPU the wrapper runs its plain version, the three flat-complex calls
of ``se_triple_args``; chip_smoke.py holds the CUDA kernels against it and
against the single-call kernels on the card. Here: the triple equals those
three calls and a numpy ordered-sum oracle bit for bit (tolerance 0.0: the
same rounded sums in the same order) in every bank dtype, with and without
a noise bank; ``mixture.synthesize_se`` goes through it once a batch; and
the wrapper's checks. Its agreement with JAX's se batch is
tests/test_torch_synth_flat.py's.
"""

import numpy as np
import pytest
import torch

from _torch_parity import bank_case, numpy_ordered_sum, to_torch
from challenge_tpu_torch.data import mixture
from challenge_tpu_torch.data.pipeline import build_banks
from challenge_tpu_torch.ops import cuda, synth
from challenge_tpu_torch.ops.synth import (
    se_triple_args, synthesize_flat, synthesize_se)

CASES = ['random', 'long_then_short', 'edges']
DTYPES = ['float32', 'bfloat16', 'int8']
ARGS = ('bgbank', 'bidx', 'boff', 'vbank', 'vidx', 'vshift', 'vw', 'nbank',
        'nidx', 'nshift', 'nw', 'vlens', 'nlens', 'bgscale')


def _args(nf, a):
    t = to_torch(a)
    return (nf,) + tuple(t.get(k) for k in ARGS)


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('name', CASES)
def test_se_equals_the_three_flat_calls(name, dtype):
    """Each output is the flat-complex call of its sub-mix, bit for bit;
    'long_then_short' has no noise bank, so only_noise is the background."""
    nf, a, _ = bank_case(name, dtype)
    args = _args(nf, a)
    outs = synthesize_se(*args)
    assert len(outs) == 3
    for out, sub in zip(outs, se_triple_args(*args)):
        ref = synthesize_flat(*sub)
        assert out.shape == ref.shape == (a['bidx'].shape[0], nf, 128)
        assert out.dtype == ref.dtype == (torch.float32 if dtype == 'float32'
                                          else torch.bfloat16)
        assert torch.equal(out, ref)


@pytest.mark.parametrize('dtype', DTYPES)
def test_se_sub_mixes_are_the_rounded_ordered_sums(dtype):
    """only_noise is the background then the noises and only_voice is 0.0
    then the voices, as a numpy oracle sums them slot by slot."""
    nf, a, oracle = bank_case('random', dtype)
    full, only_noise, only_voice = synthesize_se(*_args(nf, a))
    no_voice = dict(oracle, vw=np.zeros_like(oracle['vw']))
    voices = {k: v for k, v in oracle.items() if k[0] != 'n'}
    voices['bgbank'] = np.zeros_like(oracle['bgbank'])
    for out, o in ((full, oracle), (only_noise, no_voice),
                   (only_voice, voices)):
        acc = torch.from_numpy(numpy_ordered_sum(nf, o, fma=False,
                                                 magnitude=False))
        assert torch.equal(out, acc.to(out.dtype))


def test_mixture_synthesize_se_is_one_triple_call(monkeypatch):
    """mixture.synthesize_se calls the triple once a batch (one kernel
    launch on the card), and its targets are the three separate calls'."""
    rng = np.random.default_rng(3)
    bgs = [rng.standard_normal((257, 40, 4)).astype(np.float32)
           for _ in range(2)]
    voices = [rng.standard_normal((257, t, 4)).astype(np.float32)
              for t in (9, 13, 7)]
    labels = np.eye(3, dtype=np.float32)
    noises = [rng.standard_normal((257, t, 4)).astype(np.float32)
              for t in (5, 11)]
    banks = build_banks(bgs, voices, labels, noises, n_frame=16,
                        flat_dtype='int8', device='cpu')
    d = mixture.draw(torch.Generator().manual_seed(2), banks, 3, 16,
                     max_voices=3, max_noises=2)
    calls = []
    real = synth.synthesize_se
    monkeypatch.setattr(synth, 'synthesize_se',
                        lambda *a: calls.append(1) or real(*a))
    spec, (label, ov, on) = mixture.synthesize_se(banks, d)
    assert len(calls) == 1
    full, only_noise, only_voice = (
        synthesize_flat(*a) for a in mixture.se_synth_args(banks, d))

    def unflat(x):
        return x.reshape(3, 16, 4, 257).permute(0, 3, 1, 2)
    for mine, ref in ((spec, full), (on, only_noise), (ov, only_voice)):
        assert mine.dtype == torch.bfloat16
        assert torch.equal(mine, unflat(ref))
    assert label.shape == (3, 3, 16, 3)


def test_se_wrapper_runs_plain_on_cpu_and_checks():
    nf, a, _ = bank_case('edges', 'int8')
    args = _args(nf, a)
    cuda.reset_launch_counts()
    synthesize_se(*args)
    assert sum(cuda.LAUNCHES.values()) == 0
    with pytest.raises(ValueError, match='bgscale is required iff'):
        synthesize_se(*args[:-1], None)
    with pytest.raises(ValueError, match='unsupported device'):
        synthesize_se(nf, *(None if x is None else x.to('meta')
                            for x in args[1:]))


def test_banks_off_16_byte_boundaries_are_refused():
    """The kernels stage rows from the bank's start rounded down to 16
    bytes, so a bank must start on one: a view 4 bytes in is refused."""
    bank = torch.zeros(2, 3, 8)
    synth._check_aligned('bank', bank)
    with pytest.raises(ValueError, match='16-byte aligned'):
        synth._check_aligned('bank', bank.flatten()[1:].reshape(1, 47))
