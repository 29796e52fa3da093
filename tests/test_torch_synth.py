"""Port of the synthesis kernel (challenge_tpu_torch/ops/synth.py) against the
JAX Pallas kernel in magnitude mode, run in interpret mode on the CPU.

On the CPU the port's wrapper runs its plain PyTorch version; the CUDA
kernel itself is held against that plain version on the card by
chip_smoke.py. Both sides get the same numpy-made banks and draws.

Tolerance: the port rounds every multiply and add of the ordered sum
``acc + w * clip`` and of ``re * re + im * im``, as its CUDA kernel does
(__fmul_rn / __fadd_rn), and equals a numpy ordered sum bit for bit. JAX's
interpret mode on the CPU contracts both into FMAs instead, which moves its
result by up to 1e-6 here; with the FMAs emulated, numpy equals JAX bit
for bit too. So the port is held to the JAX kernel at the JAX package's
own bound for its kernel against its XLA path, rtol 1e-5 / atol 1e-6
(tests/test_pallas_synth.py).
"""

import numpy as np
import pytest
import torch

from _torch_parity import numpy_ordered_sum
from challenge_tpu.ops.pallas_synth import synthesize_windows
from challenge_tpu_torch.ops import cuda
from challenge_tpu_torch.ops.synth import (
    synthesize_magnitude, synthesize_magnitude_plain)

RTOL, ATOL = 1e-5, 1e-6


def _case(name):
    """(n_frame, arrays) for one adversarial draw; flat width 128 (the JAX
    kernel's lane rule), rows multiples of 8 (its sublane rule)."""
    if name == 'random':
        # negative shifts, shifts up to n_frame - 1, voices and noises
        rng = np.random.default_rng(1)
        b, nf, f = 4, 64, 128
        a = dict(
            bgbank=rng.standard_normal((3, 96, f)),
            bidx=rng.integers(0, 3, b), boff=rng.integers(0, 96 - nf, b),
            vbank=rng.standard_normal((5, 24, f)),
            vidx=rng.integers(0, 5, (b, 3)),
            vshift=rng.integers(-20, nf, (b, 3)),
            vw=rng.uniform(0.1, 1, (b, 3)),
            nbank=rng.standard_normal((4, 16, f)),
            nidx=rng.integers(0, 4, (b, 2)),
            nshift=rng.integers(-12, nf, (b, 2)),
            nw=rng.uniform(0.1, 1, (b, 2)))
    elif name == 'long_then_short':
        # a long clip then short ones through the same slot positions;
        # rows past each clip's length are zero (the bank contract)
        rng = np.random.default_rng(4)
        b, nf, f = 2, 64, 128
        lens = np.array([96, 20, 50, 96])
        vbank = rng.standard_normal((4, 96, f))
        for i, n in enumerate(lens):
            vbank[i, n:] = 0.0
        vidx = np.array([[0, 1, 2], [3, 2, 1]])
        a = dict(bgbank=rng.standard_normal((2, 128, f)),
                 bidx=np.array([0, 1]), boff=np.array([3, 40]),
                 vbank=vbank, vidx=vidx,
                 vshift=rng.integers(-10, nf, (b, 3)),
                 vw=rng.uniform(0.5, 1, (b, 3)), vlens=lens[vidx])
    elif name == 'edges':
        # w == 0 slots, a shift of exactly n_frame (lands nowhere), a shift
        # that leaves one row inside, a clip fully before the window
        rng = np.random.default_rng(6)
        b, nf, f = 3, 32, 128
        vw = rng.uniform(0.2, 1, (b, 4))
        vw[0, 1] = vw[2, 0] = vw[1, 3] = 0.0
        nw = rng.uniform(0.2, 1, (b, 2))
        nw[:, 1] = 0.0
        a = dict(bgbank=rng.standard_normal((2, 64, f)),
                 bidx=np.array([0, 1, 1]), boff=np.array([0, 8, 5]),
                 vbank=rng.standard_normal((3, 16, f)),
                 vidx=rng.integers(0, 3, (b, 4)),
                 vshift=np.array([[nf, -15, 0, 31], [-16, nf - 1, 7, 3],
                                  [2, 2, 2, -40]]),
                 vw=vw,
                 nbank=rng.standard_normal((2, 8, f)),
                 nidx=rng.integers(0, 2, (b, 2)),
                 nshift=np.array([[-7, 0], [nf - 8, 4], [nf, 1]]), nw=nw)
    else:
        raise KeyError(name)
    ints = {'bidx', 'boff', 'vidx', 'vshift', 'nidx', 'nshift', 'vlens'}
    return nf, {k: np.asarray(v, np.int32 if k in ints else np.float32)
                for k, v in a.items()}


@pytest.mark.parametrize('name', ['random', 'long_then_short', 'edges'])
def test_plain_matches_pallas_magnitude(name):
    nf, a = _case(name)
    ref = synthesize_windows(nf, **a, magnitude=True, interpret=True)
    out = synthesize_magnitude_plain(
        nf, **{k: torch.from_numpy(v) for k, v in a.items()})
    assert out.shape == ref.shape == (a['bidx'].shape[0], nf, 64)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize('name', ['random', 'long_then_short', 'edges'])
def test_plain_is_the_rounded_ordered_sum(name):
    """Bit for bit: the port equals the unfused ordered sum, and JAX's CPU
    interpret mode equals the FMA-contracted one, so the FMAs are the whole
    gap between the two."""
    nf, a = _case(name)
    out = synthesize_magnitude_plain(
        nf, **{k: torch.from_numpy(v) for k, v in a.items()})
    np.testing.assert_array_equal(out.numpy(),
                                  numpy_ordered_sum(nf, a, fma=False))
    ref = synthesize_windows(nf, **a, magnitude=True, interpret=True)
    np.testing.assert_array_equal(np.asarray(ref),
                                  numpy_ordered_sum(nf, a, fma=True))


def test_wrapper_on_cpu_runs_plain_version_without_counting():
    nf, a = _case('random')
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    cuda.reset_launch_counts()
    out = synthesize_magnitude(nf, **t)
    assert torch.equal(out, synthesize_magnitude_plain(nf, **t))
    assert sum(cuda.LAUNCHES.values()) == 0


def test_wrapper_refuses_devices_without_the_kernel():
    nf, a = _case('random')
    t = {k: torch.from_numpy(v).to('meta') for k, v in a.items()}
    with pytest.raises(ValueError, match='unsupported device'):
        synthesize_magnitude(nf, **t)


def test_kernel_library_name_tracks_its_source(tmp_path, monkeypatch):
    """The build cache is keyed by the source: an edited kernel gets a new
    library name, so a stale build is never loaded."""
    src = tmp_path / 'k.cu'
    src.write_text('// v1\n')
    monkeypatch.setattr(cuda, 'CSRC', tmp_path)
    first = cuda._library_path('k')
    src.write_text('// v2\n')
    assert cuda._library_path('k') != first
    assert first.parent == cuda.BUILD_DIR
