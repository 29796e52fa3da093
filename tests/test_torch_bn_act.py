"""BatchNorm + swish of the EfficientNet backbone
(challenge_tpu_torch/ops/bn_act.py; its kernels, csrc/bn_swish.cu, run only
on the card, where chip_smoke.py holds them to the plain path).

On the CPU ``bn_act`` is the plain path, ``F.silu(bn(x))`` or ``bn(x)``:
held bit for bit (outputs, running buffers, gradients), in training and
eval mode, float32 and bfloat16 ``compute_dtype``, NCHW and channels_last
inputs (the CPU's convolutions hand the backbone channels_last), and in a
remat recompute, which leaves the running buffers alone.

``bn_act_grad_plain``, the kernels' backward algebra in plain ops, against
autograd of the plain forward: within 1e-12 of each gradient's peak in
float64 (the two reorder float64 sums; measured 4e-16); within 1e-6 in
float32 (float32 sums over the same elements grouped otherwise, and
swish's gradient through ``torch.sigmoid``; measured 1.5e-7); in
bfloat16 the input gradient within 2^-8 of its peak (one bfloat16
rounding step of the largest element; measured 3.7e-4) and the weight
and bias gradients, float32 sums, within 1e-6; on a 2-rank gloo mesh
(``layers.cross_replica``), each rank's share within 1e-12 in float64.
"""

import copy

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from challenge_tpu_torch.models import effnet, layers
from challenge_tpu_torch.models.layers import BatchNorm
from challenge_tpu_torch.ops import bn_act as ba
from challenge_tpu_torch.parallel import launch
from challenge_tpu_torch.parallel import mesh as mesh_lib

# B0-like (stem at 32 x 64 input) and B4-like (48 channels; a deep stage's
# 3 x 8 planes of 144 channels) activations, small enough for the CPU
SHAPES = [(2, 32, 20, 64), (3, 48, 5, 16), (2, 144, 3, 8)]
DTYPES = {'float32': (torch.float32, None),
          'bfloat16': (torch.bfloat16, torch.bfloat16)}


def make_bn(c: int, training: bool, seed: int = 0, dtype=None,
            param_dtype=torch.float32) -> BatchNorm:
    """A BatchNorm with drawn weights and running statistics."""
    g = torch.Generator().manual_seed(seed)
    bn = BatchNorm(c).to(param_dtype)
    with torch.no_grad():
        bn.weight.copy_(torch.rand(c, generator=g) + 0.5)
        bn.bias.copy_(torch.randn(c, generator=g) * 0.3)
        bn.running_mean.copy_(torch.randn(c, generator=g) * 0.2)
        bn.running_var.copy_(torch.rand(c, generator=g) + 0.5)
    bn.compute_dtype = dtype
    return bn.train(training)


def make_x(shape, dtype, channels_last: bool = False, seed: int = 1):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal(shape) * 2.0 + 0.7).to(dtype)
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
    return x.requires_grad_(True)


def _grads(bn, x, swish: bool, fn):
    y = fn(bn, x, swish)
    d = torch.from_numpy(np.random.default_rng(2).standard_normal(
        tuple(y.shape))).to(y.dtype)
    return (y,) + torch.autograd.grad(y, (x, bn.weight, bn.bias), d)


def _plain(bn, x, swish):
    y = bn(x)
    return F.silu(y) if swish else y


@pytest.mark.parametrize('channels_last', [False, True],
                         ids=['nchw', 'channels_last'])
@pytest.mark.parametrize('dtype', list(DTYPES))
@pytest.mark.parametrize('training', [True, False], ids=['train', 'eval'])
@pytest.mark.parametrize('swish', [True, False], ids=['swish', 'bn'])
@pytest.mark.parametrize('shape', SHAPES, ids=str)
def test_cpu_path_is_the_plain_path(shape, swish, training, dtype,
                                    channels_last):
    """On the CPU, ``bn_act`` is ``F.silu(bn(x))`` / ``bn(x)`` bit for bit:
    the output, its gradients and the running buffers."""
    in_dtype, compute = DTYPES[dtype]
    bn = make_bn(shape[1], training, dtype=compute)
    twin = copy.deepcopy(bn)
    x = make_x(shape, in_dtype, channels_last)
    got = _grads(bn, x, swish, ba.bn_act)
    want = _grads(twin, x, swish, _plain)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    for name in ('running_mean', 'running_var'):
        assert torch.equal(getattr(bn, name), getattr(twin, name))
    if training:
        assert not torch.equal(bn.running_mean,
                               make_bn(shape[1], False).running_mean)


@pytest.mark.parametrize('swish', [True, False], ids=['swish', 'bn'])
def test_remat_recompute_leaves_the_running_buffers(swish):
    """A remat's first pass moves the running statistics as a plain
    training forward does; its recompute leaves them alone (C11)."""
    bn = make_bn(48, True)
    twin = copy.deepcopy(bn)
    x = make_x(SHAPES[1], torch.float32)
    draws = []
    with layers._remat_pass(draws, False):
        first = ba.bn_act(bn, x, swish)
    _plain(twin, x, swish)
    assert torch.equal(bn.running_mean, twin.running_mean)
    moved = (bn.running_mean.clone(), bn.running_var.clone())
    with layers._remat_pass(draws, True):
        again = ba.bn_act(bn, x, swish)
    assert torch.equal(first, again)
    assert torch.equal(bn.running_mean, moved[0])
    assert torch.equal(bn.running_var, moved[1])


def _rel(a, b) -> float:
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).abs().max() / b.abs().max())


def mirror_gaps(shape, swish, training, in_dtype, compute, param_dtype):
    """(dx, dweight, dbias) gaps of ``bn_act_grad_plain`` to autograd of the
    plain forward, each over the autograd gradient's peak."""
    bn = make_bn(shape[1], training, dtype=compute, param_dtype=param_dtype)
    x = make_x(shape, in_dtype)
    _, gx, gw, gb = _grads(copy.deepcopy(bn), x, swish, _plain)
    y = _plain(copy.deepcopy(bn), x, swish)
    d = torch.from_numpy(np.random.default_rng(2).standard_normal(
        tuple(y.shape))).to(y.dtype)
    with torch.no_grad():
        stats = ba.bn_stats_plain(bn, x.detach())
        got = ba.bn_act_grad_plain(d, x.detach(), *stats, bn.weight,
                                   bn.bias, swish, training, compute)
    return [_rel(g, w) for g, w in zip(got, (gx, gw, gb))]


@pytest.mark.parametrize('training', [True, False], ids=['train', 'eval'])
@pytest.mark.parametrize('swish', [True, False], ids=['swish', 'bn'])
@pytest.mark.parametrize('shape', SHAPES, ids=str)
def test_grad_plain_is_autograd_float64(shape, swish, training):
    gaps = mirror_gaps(shape, swish, training, torch.float64, None,
                       torch.float64)
    assert max(gaps) <= 1e-12, gaps


@pytest.mark.parametrize('dtype', list(DTYPES))
@pytest.mark.parametrize('training', [True, False], ids=['train', 'eval'])
@pytest.mark.parametrize('swish', [True, False], ids=['swish', 'bn'])
@pytest.mark.parametrize('shape', SHAPES, ids=str)
def test_grad_plain_is_autograd_lowp(shape, swish, training, dtype):
    in_dtype, compute = DTYPES[dtype]
    dx, dw, db = mirror_gaps(shape, swish, training, in_dtype, compute,
                             torch.float32)
    assert dx <= (1e-6 if dtype == 'float32' else 2.0 ** -8), dx
    assert max(dw, db) <= 1e-6, (dw, db)


def test_grad_plain_matches_autograd_bit_for_bit_without_swish_in_eval():
    """In eval mode without swish the mirror is autograd's arithmetic
    exactly (dx = dout * mul, the same two sums)."""
    assert mirror_gaps(SHAPES[0], False, False, torch.float32, None,
                       torch.float32) == [0.0, 0.0, 0.0]


MESH_SHAPE = (4, 48, 5, 16)     # the global batch: 2 samples a rank


def mesh_rank(swish: bool) -> dict:
    """One rank's share of the mesh check (``launch.run`` target): the plain
    forward under ``cross_replica`` differentiated by autograd, and
    ``bn_act_grad_plain`` with the mesh, on this rank's 2 samples, in
    float64."""
    mesh = mesh_lib.current()
    share = slice(2 * mesh.rank, 2 * mesh.rank + 2)
    x_all = make_x(MESH_SHAPE, torch.float64).detach()
    d_all = torch.from_numpy(np.random.default_rng(2).standard_normal(
        MESH_SHAPE))
    x = x_all[share].clone().requires_grad_(True)
    bn = make_bn(MESH_SHAPE[1], True, param_dtype=torch.float64)
    with layers.cross_replica(mesh):
        y = _plain(bn, x, swish)
        want = torch.autograd.grad(y, (x, bn.weight, bn.bias), d_all[share])
        # the statistics of the global batch
        stats = ba.bn_stats_plain(make_bn(MESH_SHAPE[1], True,
                                          param_dtype=torch.float64), x_all)
        got = ba.bn_act_grad_plain(d_all[share], x.detach(), *stats,
                                   bn.weight.detach(), bn.bias.detach(),
                                   swish, True, mesh=mesh)
    return {'gaps': [_rel(g, w) for g, w in zip(got, want)]}


@pytest.mark.parametrize('swish', [True, False], ids=['swish', 'bn'])
def test_grad_plain_on_a_two_rank_mesh(swish, tmp_path):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ranks = launch.run('test_torch_bn_act:mesh_rank', (swish,),
                           ['cpu', 'cpu'], workdir=str(tmp_path))
    finally:
        torch.set_num_threads(n)
    for r in ranks:
        assert max(r['gaps']) <= 1e-12, ranks


@pytest.mark.parametrize('case', [
    'three_d', 'float64', 'float16', 'dtype_mismatch', 'feature_dim',
    'channels', 'strided', 'cpu'])
def test_wrapper_refuses_what_the_kernels_do_not_take(case):
    bn = make_bn(48, True)
    x = torch.zeros(2, 48, 5, 16)
    err = ValueError
    if case == 'three_d':
        x = x[0]
    elif case == 'float64':
        x, err = x.double(), TypeError
    elif case == 'float16':
        x, err = x.half(), TypeError
        bn.compute_dtype = torch.float16
    elif case == 'dtype_mismatch':
        bn.compute_dtype, err = torch.bfloat16, TypeError
    elif case == 'feature_dim':
        bn.feature_dim = -1
    elif case == 'channels':
        x = torch.zeros(2, 24, 5, 16)
    elif case == 'strided':
        x = torch.zeros(2, 48, 5, 32)[..., ::2]
    with pytest.raises(err, match='bn_act'):
        ba.check(bn, x)


@pytest.mark.parametrize('m, c, want', [
    (491520, 48, (16, 1056)),   # B4's stem: 12 x 40 x 1,024 rows
    (491520, 24, (32, 960)),
    (491520, 144, (4, 1056)),
    (2304, 1632, (4, 36)),      # a last-stage BN: 12 x 3 x 64 rows
    (200, 48, (1, 1)),          # under 16 rows a thread: one row thread
    (4096, 48, (16, 16)),       # few rows: splits of 16 rows a thread
], ids=str)
def test_aten_column_reduce(m, c, want):
    """ATen's (block height, splits) for a column reduction, worked out by
    hand from ``Reduce.cuh``'s ``setReduceConfig`` for an H100 (132 SMs,
    2,048 threads each): e.g. 48 columns in vectors of 4 give 12, a block
    8 wide (its power of two under 12) and 128 / 8 = 16 high, 2 blocks
    across; 2,112 blocks fill the card, so min(2,112 / 2, 30,720 / 16)
    splits."""
    assert ba.aten_column_reduce(m, c, 132, 2048) == want


@pytest.mark.parametrize('b, c, hw, want', [
    (12, 48, 40 * 1024, (32, 16, 11)),   # B4's stem BN, NCHW
    (12, 144, 10 * 1024, (32, 16, 1)),   # 240 a thread: no splits
    (12, 1632, 3 * 64, (32, 1, 1)),      # 72 a lane: each row a channel
    (2, 48, 8, (16, 1, 1)),              # 16 inputs a channel: 16 lanes
    (12, 8, 4096, (64, 8, 1)),           # 8 channels: a block 64 wide
], ids=str)
def test_aten_plane_reduce(b, c, hw, want):
    """ATen's block and splits for an NCHW reduction over B and H*W, from
    ``setReduceConfig`` by hand: 491,520 inputs a channel over 32 lanes
    and 16 rows is 960 a thread, so min(528 / 48, 960 / 16) = 11 splits
    (4 blocks of 512 threads on each of 132 SMs)."""
    assert ba.aten_plane_reduce(b, c, hw, 132, 2048) == want


def test_reduce_geometry():
    """channels_last takes ATen's column configuration and vectors of 4
    channels where C allows; NCHW ATen's plane configuration."""
    assert ba.reduce_geometry((12, 48, 40, 1024), 4, 1) == (1, 1056, 1, 16)
    assert ba.reduce_geometry((12, 42, 40, 1024), 4, 1)[0] == 0
    assert ba.reduce_geometry((12, 48, 40, 1024), 2, 1, aligned=False)[0] \
        == 0
    assert ba.reduce_geometry((12, 48, 40, 1024), 4, 0) == (0, 11, 32, 16)
    assert ba.reduce_geometry((12, 1, 40, 1024), 4, 1)[3] <= ba.THREADS
    assert ba.vector_width((2, 48, 5, 3), 2, 1) == 8
    assert ba.vector_width((2, 44, 5, 3), 2, 1) == 1


def test_b4_launches_a_training_step():
    """B4's backbone routes 96 BatchNorms, 64 followed by swish (stem, head,
    30 expand, 32 depthwise) and 32 project BNs without: 96 x (3 forward +
    3 backward) launches a training step, 96 a validation step."""
    with torch.device('meta'):
        backbone = effnet.EfficientNetBackbone(4, 2)
    assert backbone.bn_act_counts() == (64, 32)
    train = ba.expected_launches(64, 32, train_steps=1)
    assert sum(train.values()) == 96 * 6
    assert train == {'bn_stats_f32': 96, 'bn_finalize': 96,
                     'bn_swish_apply_f32': 64, 'bn_apply_f32': 32,
                     'bn_grad_finalize': 96,
                     'bn_swish_grad_reduce_f32': 64,
                     'bn_grad_reduce_f32': 32,
                     'bn_swish_grad_input_f32': 64,
                     'bn_grad_input_f32': 32}
    assert ba.expected_launches(64, 32, 'bf16', 0, 1) == {
        'bn_swish_apply_bf16': 64, 'bn_apply_bf16': 32}
    assert not any(k.startswith('synth_') or k.startswith('mark_')
                   for k in train)


def test_kernel_source_and_argument_types_agree():
    """Every entry point the wrapper binds is in csrc/bn_swish.cu with as
    many parameters as its ctypes argument types, the stream last."""
    import re
    from challenge_tpu_torch.ops import cuda
    src = (cuda.CSRC / 'bn_swish.cu').read_text()
    for kind, types in ba._ARGTYPES.items():
        for entry in ([kind] if 'finalize' in kind
                      else [f'{kind}_f32', f'{kind}_bf16']):
            name = entry if 'finalize' in kind else kind + '_##SUFFIX'
            m = re.search(re.escape(f'int {name}(') + r'([^)]*)\)', src)
            assert m, entry
            params = [p for p in m.group(1).replace('\\', ' ').split(',')
                      if p.strip()]
            assert len(params) == len(types) + 1, entry
            assert params[-1].split()[-1] == 'stream', entry


def test_row_order_follows_the_gradients_memory():
    """The backward sums a gradient's rows in the order ATen reduces them:
    channels_last (B, H, W); the density head's gradient, [B, W, H, C] in
    memory, (B, W, H); none where the channels are not the fastest dim or
    the tensor is not dense (the gradient is then copied to x's layout)."""
    cl = torch.zeros(2, 8, 3, 4).contiguous(memory_format=torch.channels_last)
    assert ba.row_order(cl) == (0, 2, 3)
    assert ba.row_order(torch.zeros(2, 4, 3, 8).permute(0, 3, 2, 1)) == \
        (0, 3, 2)
    assert ba.row_order(torch.zeros(2, 8, 3, 4)) is None
    assert ba.row_order(torch.zeros(1).expand(2, 8, 3, 4)) is None
    assert ba.row_order(cl[:, :, :, ::2]) is None
