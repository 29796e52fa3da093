"""The port's se v9 pretrain path (``models/senet.py``, ``train/losses.py``
``se_loss``, ``train/state.py``'s AGC, freeze mask and Keras Adam,
``data/pipeline.py``'s se batch) against the benchmark's plain reference
(``h100_bench/reference/se.py``, ``se_train.py``, ``se_data.py``), the one
that decides the ``se_v9.fit`` cell's ``correct`` on the card.

On the CPU at full width, batch 2 x 32 frames of 256 rows, with one state
dict drawn from a seed (``h100_bench.gen.draw_weights``) loaded into both.
Tolerances, each with its reason:

* the forward's three outputs, the loss and its parts: 1e-6 of the
  output's peak (the loss: relative). Both run the same float32 torch
  convolutions and matrix products on the same CPU; the BatchNorms differ
  only in how the two packages spell the same statistics, which moves
  the last bits;
* the U-Net's gradients: 1e-5 of each leaf's largest element, since the
  backward sums a few more rounded terms;
* three masked Keras Adam + AGC steps: each trained leaf's change from
  the drawn weights within 5e-4 of the reference's change, in norm (read:
  4.0e-5 at most). Adam moves an element by about lr whatever the size of
  its gradient, so the rounding of a near-zero gradient shows whole after
  the division by the root; the cell on the card compares the changes'
  norms for the same reason. The frozen head's parameters and BatchNorm
  buffers unchanged bit for bit on both sides;
* the se triple, the preprocess and the labels: 0.0, the same ordered
  float32 sums from the same draws.

A fault in the reference, its head unfrozen or its speech loss weighted 1
in place of 10, reads far outside these tolerances (changes 1.0 and more
apart on some leaf).
"""

import contextlib

import pytest
import torch

from challenge_tpu_torch.config import Config
from challenge_tpu_torch.data.pipeline import build_banks, make_feature_fn
from challenge_tpu_torch.models.registry import get_model
from challenge_tpu_torch.train import losses
from challenge_tpu_torch.train.state import init_state, make_grad_update
from h100_bench import gen
from h100_bench.control_se import unfrozen_head
from h100_bench.reference import data as ref_data
from h100_bench.reference import se as ref_se
from h100_bench.reference import se_data, se_train
from h100_bench.reference import train as ref_train

N_FRAME, BATCH = 32, 2
SEED = 11
CONFIG = {'model': {'v': 9, 'n_classes': 3, 'n_frame': N_FRAME,
                    'batch_size': BATCH},
          'train': {'pretrain': True, 'optimizer': 'adam', 'lr': 1e-3,
                    'clipvalue': 0.01, 'max_voices': 7, 'max_noises': 2,
                    'snr': -20.0}}
SOURCES = [4, 120, 10, [10, 40], 4, [8, 20]]
FWD_TOL = 1e-6
GRAD_TOL = 1e-5
STEP_TOL = 5e-4


@pytest.fixture(scope='module', autouse=True)
def _two_torch_threads():
    """The full-width U-Net on two torch threads: every core oversubscribes
    the CPU when the suite runs in several workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def weights():
    with torch.device('meta'):
        shapes = ref_se.build(CONFIG)
    return gen.draw_weights(shapes, SEED, 'cpu')


def _config():
    return Config(model_type='se', v=9, n_frame=N_FRAME, batch_size=BATCH,
                  pretrain=True)


def _bundle(weights):
    bundle = get_model(_config(), device='cpu', seed=0)
    bundle.module.load_state_dict(weights)
    return bundle


def _reference(weights):
    module = ref_se.build(CONFIG)
    module.load_state_dict(weights)
    return module


@pytest.fixture(scope='module')
def batch():
    """One se batch (x, (labels, speech target, noise target)) of the
    reference's batch function, on seeded sources."""
    srcs = gen.sources(gen.rng_seed(SEED, 0), *SOURCES)
    banks = ref_data.build_banks(*srcs, N_FRAME, 3, 'cpu')
    g = torch.Generator().manual_seed(5)
    mc = {**CONFIG['model'], **CONFIG['train']}
    return se_data.batch(g, banks, mc)


def _gap(a, b):
    """The largest |a - b| over b's peak."""
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def test_parameter_count_and_names(weights):
    port = get_model(_config(), device='cpu', seed=0).module
    assert list(port.state_dict()) == list(weights)
    trained = [n for n, _ in port.named_parameters() if n.startswith('se.')]
    assert se_train.trained(_reference(weights))[0] == trained
    assert sum(p.numel() for p in port.parameters()) == 21_564_847
    assert sum(p.numel() for n, p in port.named_parameters()
               if n in trained) == 9_216_044


@pytest.mark.parametrize('training', [True, False], ids=['train', 'eval'])
def test_forward_matches_reference(weights, batch, training):
    """(class, speech, noise) in pretrain's training mode (the head's
    BatchNorms in inference mode) and in eval mode."""
    port, ref = _bundle(weights).module, _reference(weights)
    port.train(training)
    ref.train(training)
    x = batch[0]
    with torch.no_grad():
        got, want = port(x), ref(x)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert _gap(g, w) <= FWD_TOL
    assert tuple(got[1].shape) == (BATCH, 256, N_FRAME, 2)


def _parts(weights, batch, train_fn):
    x, y = batch
    port, ref = _bundle(weights).module, _reference(weights)
    port.train()
    ref.train()
    total, parts = losses.se_loss(y, port(x))
    r_total, r_parts = train_fn(y, ref(x))
    return (total, list(parts.values()), port), (r_total, r_parts, ref)


def test_loss_and_parts_match_reference(weights, batch):
    (total, parts, _), (r_total, r_parts, _) = _parts(
        weights, batch, se_train.loss_parts)
    for got, want in zip([total] + parts, [r_total] + r_parts):
        got, want = float(got.detach()), float(want.detach())
        assert abs(got - want) <= FWD_TOL * abs(want)
    w = losses.SE_LOSS_WEIGHTS
    assert tuple(w) == se_train.LOSS_WEIGHTS == (1.0, 10.0, 10.0)


def test_unet_gradients_match_reference(weights, batch):
    (total, _, port), (r_total, _, ref) = _parts(weights, batch,
                                                 se_train.loss_parts)
    names, params, _ = se_train.trained(ref)
    own = dict(port.named_parameters())
    got = torch.autograd.grad(total, [own[n] for n in names])
    want = torch.autograd.grad(r_total, params)
    gaps = {n: _gap(g, w) for n, g, w in zip(names, got, want)}
    assert max(gaps.values()) <= GRAD_TOL, max(gaps.items(),
                                               key=lambda kv: kv[1])


def _port_steps(weights, batches):
    """Three steps of the port's grad and update functions (AGC, the
    pretrain freeze mask, Keras Adam); returns the module's state dict."""
    bundle = _bundle(weights)
    state = init_state(bundle, 0)
    bundle.module.load_state_dict(weights)
    grad_fn, update_fn = make_grad_update(bundle)
    for b in batches:
        grads, _ = grad_fn(state.module, b)
        update_fn(state, grads)
    return {k: v.clone() for k, v in state.module.state_dict().items()}


def _ref_steps(weights, batches):
    module = _reference(weights)
    _, params, transposed = se_train.trained(module)
    opt = ref_train.Optimizer(params, CONFIG['train'])
    for x, y in batches:
        se_train.train_step(module, opt, transposed, x, y)
    return {k: v.clone() for k, v in module.state_dict().items()}


@pytest.fixture(scope='module')
def three_batches(batch):
    """The batch, then two more of the same draws with the input scaled,
    so the three steps differ."""
    x, y = batch
    return [batch, (x * 0.5, y), (x * 2.0, y)]


@pytest.fixture(scope='module')
def port_after(weights, three_batches):
    return _port_steps(weights, three_batches)


def _step_gaps(after, ref_after, weights):
    """Each trained leaf's |change - the reference's change| over the
    reference's change, in norm."""
    out = {}
    for k in weights:
        if k.startswith('se.') and 'running' not in k:
            change = after[k] - weights[k]
            ref_change = ref_after[k] - weights[k]
            out[k] = float((change - ref_change).norm() / ref_change.norm())
    return out


def test_three_masked_steps_match_reference(weights, three_batches,
                                            port_after):
    ref_after = _ref_steps(weights, three_batches)
    gaps = _step_gaps(port_after, ref_after, weights)
    assert max(gaps.values()) <= STEP_TOL, max(gaps.items(),
                                               key=lambda kv: kv[1])
    moved = [k for k in gaps if not torch.equal(port_after[k], weights[k])]
    assert len(moved) == len(gaps)
    for after in (port_after, ref_after):
        for k in weights:
            if k.startswith('vad.'):
                assert torch.equal(after[k], weights[k]), k


@contextlib.contextmanager
def _speech_weight_one():
    weights = se_train.LOSS_WEIGHTS
    se_train.LOSS_WEIGHTS = (1.0, 1.0, 10.0)
    try:
        yield
    finally:
        se_train.LOSS_WEIGHTS = weights


@pytest.mark.parametrize('fault', [unfrozen_head, _speech_weight_one],
                         ids=['unfrozen_head', 'speech_weight_1'])
def test_a_fault_in_the_reference_is_caught(weights, three_batches,
                                            port_after, fault):
    with fault():
        ref_after = _ref_steps(weights, three_batches)
    gaps = _step_gaps(port_after, ref_after, weights)
    frozen = max(float((ref_after[k] - weights[k]).abs().max())
                 for k in weights if k.startswith('vad.'))
    assert max(gaps.values()) > 100 * STEP_TOL or frozen > 0.0


def test_se_batch_matches_reference():
    """The port's se batch (one se-triple synthesis, the preprocess, the
    pooled labels) against the reference's from the same sources and
    generator seed."""
    srcs = gen.sources(gen.rng_seed(SEED, 1), *SOURCES)
    banks = build_banks(*srcs, n_classes=3, one_hot=True, n_frame=N_FRAME,
                        flat_dtype='float32', device='cpu')
    r_banks = ref_data.build_banks(*srcs, N_FRAME, 3, 'cpu')
    fn = make_feature_fn(_config(), training=True, device='cpu')
    mc = {**CONFIG['model'], **CONFIG['train']}
    for seed in (3, 4):
        x, y = fn(torch.Generator().manual_seed(seed), banks)
        rx, ry = se_data.batch(torch.Generator().manual_seed(seed), r_banks,
                               mc)
        assert tuple(x.shape) == (BATCH, 256, N_FRAME, 2)
        assert tuple(y[1].shape) == (BATCH, 256, N_FRAME, 1)
        torch.testing.assert_close(x, rx, rtol=0, atol=0)
        for got, want in zip(y, ry):
            torch.testing.assert_close(got, want, rtol=0, atol=0)
        assert float(ry[1].abs().max()) > 0 and float(ry[0].max()) == 1.0
