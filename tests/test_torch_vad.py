"""The port's VADModel (challenge_tpu_torch/models/vad.py, layers.py) and the
flax -> torch weight bridge (interop/jax_weights.py) against the JAX
``VADModel`` v8, shrunk to base_fsize 8 and td_dim 32 on a 32 x 64 input.

The same numpy-made variables go to both sides, with BN statistics away
from their initial values. Tolerance 1e-5 (abs and relative): both compute
in float32, and only the order of the convolution and matmul sums differs.
"""

import copy

import jax
import numpy as np
import pytest
import torch

from _torch_parity import N_FRAME, N_MELS, vad_variables
from challenge_tpu.models.vad import VADModel as JVADModel
from challenge_tpu_torch.interop.jax_weights import flax_to_state_dict
from challenge_tpu_torch.models.vad import VADModel

SHAPE = (N_MELS, N_FRAME, 2)
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope='module')
def models():
    jm = JVADModel(v=8, base_fsize=8, td_dim=32)
    variables = vad_variables(jm, SHAPE)
    pm = VADModel(v=8, base_fsize=8, td_dim=32, n_mels=N_MELS, n_chan=2)
    pm.load_state_dict(flax_to_state_dict(variables), strict=True)
    x = np.random.default_rng(1).standard_normal((3,) + SHAPE)
    return jm, variables, pm, x.astype(np.float32)


def test_bridge_covers_every_tensor(models):
    jm, variables, pm, _ = models
    sd = flax_to_state_dict(variables)
    assert set(sd) == set(pm.state_dict())
    n_flax = sum(np.asarray(a).size for a in jax.tree.leaves(variables))
    assert n_flax == sum(t.numel() for t in pm.state_dict().values())
    # Conv HWIO -> OIHW, Dense [in, out] -> [out, in]
    k = np.asarray(variables['params']['ConvMPBlock_1']['Conv_0']['kernel'])
    np.testing.assert_array_equal(sd['blocks.1.convs.0.weight'].numpy(),
                                  k.transpose(3, 2, 0, 1))
    d = np.asarray(variables['params']['Dense_0']['kernel'])
    np.testing.assert_array_equal(sd['td.weight'].numpy(), d.T)


def test_eval_forward_matches_jax(models):
    jm, variables, pm, x = models
    ref = jax.jit(lambda v, x: jm.apply(v, x, training=False))(variables, x)
    pm.eval()
    with torch.no_grad():
        out = pm(torch.from_numpy(x))
    assert out.shape == (3, N_FRAME // 32, 3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def _train_forward(pm, x):
    """(output, state_dict after the BN update) of one training-mode
    forward; the module's weights and statistics are left as they were."""
    before = {k: v.clone() for k, v in pm.state_dict().items()}
    pm.train()
    with torch.no_grad():
        out = pm(x)
    after = {k: v.clone() for k, v in pm.state_dict().items()}
    pm.load_state_dict(before)
    return out, after


def test_train_forward_and_bn_stats_match_jax(models):
    """Batch-statistics BN: the output, and the new running statistics
    (momentum 0.99, the biased variance stored as flax stores it).

    The training-mode output is held at atol 5e-5, not 1e-5: it is badly
    conditioned at this size (the head's BNs see 3 x 2 = 6 samples, and
    E[x^2] - E[x]^2 cancels), and JAX's own float32 CPU result lies 2.3e-5
    from a float64 evaluation of the same weights, while the port's lies
    within 1e-5 of it (checked below). The statistics move by 0.01 of the
    batch values and are held at 1e-5."""
    jm, variables, pm, x = models
    ref, mut = jax.jit(lambda v, x: jm.apply(
        v, x, training=True, mutable=['batch_stats']))(variables, x)
    out, after = _train_forward(pm, torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                               rtol=1e-5, atol=5e-5)
    exact, _ = _train_forward(copy.deepcopy(pm).double(),
                              torch.from_numpy(x).double())
    np.testing.assert_allclose(out.numpy(), exact.numpy(), **TOL)
    new = flax_to_state_dict(
        {'batch_stats': jax.device_get(mut)['batch_stats']})
    assert len(new) == 2 * 17         # mean and var of 14 conv + 3 head BNs
    for k, v in new.items():
        np.testing.assert_allclose(after[k].numpy(), v.numpy(), **TOL,
                                   err_msg=k)


def test_unported_versions_raise():
    """Every vad version is built (v6, v7 and v9: test_torch_vad_versions.py)
    and so are the EfficientNet-SED family (test_torch_effnet.py) and the
    density head (test_torch_density.py); bfloat16 compute builds too
    (test_torch_bf16.py)."""
    from challenge_tpu_torch.config import Config
    from challenge_tpu_torch.models.effnet import EffNetSED
    from challenge_tpu_torch.models.registry import get_model
    for v in range(1, 10):
        assert VADModel(v=v, base_fsize=8, td_dim=32).v == v
    bundle = get_model(Config(model_type='eff', v=1, n_mels=32, n_frame=64),
                       device='cpu')
    assert isinstance(bundle.module, EffNetSED) and bundle.needs_dropout_gen
    density = EffNetSED(head='density', n_mels=32, n_frame=64)
    assert density.density and len(density.denses) == 1


def test_odd_mel_pooling_is_same_padded():
    """'SAME' 2x2/2 max pooling keeps the odd edge (5 -> 3) and pads with
    -inf, like flax: all inputs are negative, so a zero pad would show."""
    from flax import linen as nn

    from challenge_tpu_torch.models.layers import max_pool_same
    x = torch.arange(2 * 5 * 7, dtype=torch.float32).reshape(1, 2, 5, 7)
    x = -1.0 - x.flip(-1)
    ref = nn.max_pool(jax.numpy.asarray(x.permute(0, 2, 3, 1).numpy()),
                      (2, 2), (2, 2), padding='SAME')
    out = max_pool_same(x)
    assert out.shape == (1, 2, 3, 4)
    np.testing.assert_array_equal(out.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(ref))
