"""Banks, batch draws and frame labels of the port
(challenge_tpu_torch/data/specset.py, mixture.py) against the JAX package.

JAX's draws are recorded at the synthesis kernel's boundary of
``sample_batch(..., use_pallas=True, layout='tfc', magnitude='flat')`` and
fed to the port's ``synthesize``; the JAX magnitude is the Pallas kernel's
(interpret mode) on those draws. Tolerances: labels, banks, the overlap-
rejection scan and the label placement must match exactly (they are copies,
0/1 arithmetic and plain indexing). The magnitude is held to the JAX
kernel's own bound against its XLA path, rtol 1e-5 / atol 1e-6
(tests/test_pallas_synth.py): JAX's interpret mode on the CPU contracts
``acc + w * clip`` and ``re * re + im * im`` into FMAs, while the port
rounds every multiply and add, as its CUDA kernel does (see
test_torch_synth.py). The port's own torch.Generator draws are checked for
their distributions."""

import jax
import numpy as np
import pytest
import torch

from _torch_parity import (
    BATCH, N_FRAME, jax_draws, jax_magnitude, port_draws, small_sources,
    strip_flat)
from challenge_tpu.data import mixture as jmix
from challenge_tpu.data.pipeline import build_banks as jax_build_banks
from challenge_tpu_torch.data import mixture
from challenge_tpu_torch.data.pipeline import build_banks

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope='module')
def sources():
    return small_sources(0)


@pytest.fixture(scope='module')
def banks(sources):
    return (jax_build_banks(*sources, n_frame=N_FRAME),
            build_banks(*sources, n_frame=N_FRAME, device='cpu'))


@pytest.mark.parametrize('which', ['backgrounds', 'voices', 'noises'])
def test_banks_equal_jax_without_padding(banks, which):
    jb, pb = (getattr(b, which) for b in banks)
    np.testing.assert_array_equal(pb.lens.numpy(), np.asarray(jb.lens))
    np.testing.assert_array_equal(pb.pos_mask.numpy(),
                                  np.asarray(jb.pos_mask))
    assert pb.contig_exact_frames == jb.contig_exact_frames
    rows = pb.flat.shape[1]
    assert rows <= jb.flat.shape[1]
    # every row the port keeps, including the cyclic tiling of the short
    # background, equals the JAX bank's row with the lane padding dropped
    np.testing.assert_array_equal(
        pb.flat.numpy(), strip_flat(np.asarray(jb.flat)[:, :rows], 4, 257))
    if which == 'backgrounds':
        assert pb.contig_exact_frames == N_FRAME        # wrapped bank
        # a window at the largest offset the draw can give stays in the bank
        lens = pb.lens.numpy()
        max_off = max(-(-N_FRAME // t) * t - N_FRAME for t in lens)
        assert max_off + N_FRAME <= rows


@pytest.fixture(scope='module')
def jax_batch(banks):
    """JAX's draws and labels for one batch of 4 at the default 7 voice and
    2 noise slots."""
    return jax_draws(banks[0], jax.random.PRNGKey(3))


@pytest.fixture(scope='module')
def port_batch(banks, jax_batch):
    return mixture.synthesize(banks[1], port_draws(jax_batch))


def test_jax_draws_reach_the_port_whole(jax_batch):
    d = port_draws(jax_batch)
    assert d.vw.shape == (BATCH, 7) and d.nw.shape == (BATCH, 2)
    assert d.bidx.dtype == d.vshift.dtype == torch.int32
    assert (d.vw != 0).any() and (d.nw != 0).any()
    assert (d.vw == 0).any()            # inactive or rejected voice slots


def test_synthesize_labels_equal_jax(jax_batch, port_batch):
    np.testing.assert_array_equal(port_batch[1].numpy(), jax_batch['label'])
    assert jax_batch['label'].any()


def test_synthesize_magnitude_matches_jax_kernel(banks, jax_batch,
                                                 port_batch):
    """JAX's recorded draws through the port's synthesize against the JAX
    Pallas kernel (interpret mode) on the same draws."""
    ref = strip_flat(jax_magnitude(banks[0], jax_batch), 2, 257)
    assert port_batch[0].shape == ref.shape == (BATCH, N_FRAME, 2 * 257)
    np.testing.assert_allclose(port_batch[0].numpy(), ref,
                               rtol=RTOL, atol=ATOL)


def test_accept_scan_matches_jax():
    rng = np.random.default_rng(5)
    b, v, t, c = 6, 7, 40, 3
    # sparse 0/1 grids so that some voices overlap and some do not
    l_frames = (rng.random((b, v, t, c)) < 0.04).astype(np.float32)
    active = rng.random((b, v)) < 0.8
    ref = np.stack([np.asarray(jmix._accept_scan(l_frames[i], active[i], t, c))
                    for i in range(b)])
    out = mixture._accept_scan(torch.from_numpy(l_frames),
                               torch.from_numpy(active))
    assert 0 < ref.sum() < active.sum()
    np.testing.assert_array_equal(out.numpy(), ref)


def test_label_placement_matches_jax_shift_rows():
    """_shift_rows: JAX's one-hot matmul formulation against the port's
    plain indexing, over every shift the placement draw can produce."""
    rng = np.random.default_rng(6)
    t_v, n_frame = 37, 48
    e = (rng.random((4, 7, t_v)) < 0.7).astype(np.float32)
    shifts = rng.integers(-t_v, n_frame + 1, (4, 7)).astype(np.int32)
    shifts[0, :3] = [-t_v, n_frame, 0]
    ref = np.asarray(jmix._shift_rows(e, shifts, n_frame))
    out = mixture._shift_rows(torch.from_numpy(e), torch.from_numpy(shifts),
                              n_frame)
    np.testing.assert_array_equal(out.numpy(), ref)


def _port_draws(n_batches, **kw):
    """Concatenated draws of the port's own generator over a bank whose
    voices all have length 40 and noises length 20, so the placement
    ranges are fixed: voices pad 24, span 24 -> shift in [1, 24]
    (exclusive offset range); noises pad 54, span 64 -> shift in
    [-10, 54] (inclusive)."""
    rng = np.random.default_rng(8)

    def specs(n, t):
        return [rng.standard_normal((257, t, 4)).astype('f4')
                for _ in range(n)]
    banks = build_banks(specs(3, 80), specs(9, 40), rng.integers(0, 3, 9),
                        specs(5, 20), n_frame=N_FRAME, device='cpu')
    gen = torch.Generator().manual_seed(0)
    ds = [mixture.draw(gen, banks, 16, N_FRAME, **kw)
          for _ in range(n_batches)]
    cat = {f: torch.cat([getattr(d, f) for d in ds]).numpy()
           for f in ('bidx', 'boff', 'vidx', 'vshift', 'vw', 'nidx',
                     'nshift', 'nw')}
    return banks, cat


def test_port_draw_ranges_and_exclusive_counts():
    banks, d = _port_draws(8)
    assert d['bidx'].dtype == np.int32 and d['vshift'].dtype == np.int32
    assert d['boff'].min() >= 0 and d['boff'].max() <= 80 - N_FRAME
    # voice / noise counts are drawn with an exclusive maxval: at most
    # max_voices - 1 = 6 voices and max_noises - 1 = 1 noise per sample
    n_v = (d['vw'] != 0).sum(1)
    n_x = (d['nw'] != 0).sum(1)
    assert n_v.min() >= 1 and n_v.max() <= 6
    assert n_x.max() == 1 and n_x.min() == 0
    # weights are 10**-u, u in [0, 2): in (0.01, 1]
    for w in (d['vw'][d['vw'] != 0], d['nw'][d['nw'] != 0]):
        assert w.min() > 0.01 and w.max() <= 1.0
    # placement: voices from the exclusive range, noises the inclusive one
    assert d['vshift'].min() == 1 and d['vshift'].max() == 24
    assert d['nshift'].min() == -10 and d['nshift'].max() == 54


def test_port_draw_streams_are_permutations():
    """Item indices are back-to-back permutations of the bank
    (pipeline.py:143-156 shuffled repeating streams)."""
    gen = torch.Generator().manual_seed(1)
    for n_items, shape in ((9, (16, 7)), (3, (16,)), (5, (4, 2))):
        s = mixture._stream_draw(gen, n_items, shape).reshape(-1).numpy()
        assert s.dtype == np.int32 and s.shape[0] == int(np.prod(shape))
        whole = len(s) // n_items * n_items
        for i in range(0, whole, n_items):
            assert sorted(s[i:i + n_items]) == list(range(n_items))
        assert len(set(s[whole:])) == len(s) - whole


def test_port_labels_follow_accepted_voices():
    """The port's synthesize puts labels exactly on the accepted voices
    (w != 0) and the accepted voices never overlap in a class."""
    banks, _ = _port_draws(1)
    gen = torch.Generator().manual_seed(2)
    d = mixture.draw(gen, banks, 16, N_FRAME)
    _, label = mixture.synthesize(banks, d)
    per_voice = label.sum(dim=(2, 3)).numpy()
    np.testing.assert_array_equal(per_voice > 0, d.vw.numpy() != 0)
    assert label.sum(dim=1).max() <= 1.0
