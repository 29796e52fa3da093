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

from _torch_parity import numpy_ordered_sum, synth_case
from challenge_tpu.ops.pallas_synth import synthesize_windows
from challenge_tpu_torch.ops import cuda
from challenge_tpu_torch.ops.synth import (
    synthesize_magnitude, synthesize_magnitude_plain)

RTOL, ATOL = 1e-5, 1e-6

@pytest.mark.parametrize('name', ['random', 'long_then_short', 'edges'])
def test_plain_matches_pallas_magnitude(name):
    nf, a = synth_case(name)
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
    nf, a = synth_case(name)
    out = synthesize_magnitude_plain(
        nf, **{k: torch.from_numpy(v) for k, v in a.items()})
    np.testing.assert_array_equal(out.numpy(),
                                  numpy_ordered_sum(nf, a, fma=False))
    ref = synthesize_windows(nf, **a, magnitude=True, interpret=True)
    np.testing.assert_array_equal(np.asarray(ref),
                                  numpy_ordered_sum(nf, a, fma=True))


def test_wrapper_on_cpu_runs_plain_version_without_counting():
    nf, a = synth_case('random')
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    cuda.reset_launch_counts()
    out = synthesize_magnitude(nf, **t)
    assert torch.equal(out, synthesize_magnitude_plain(nf, **t))
    assert sum(cuda.LAUNCHES.values()) == 0


def test_wrapper_refuses_devices_without_the_kernel():
    nf, a = synth_case('random')
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
