"""BatchNorm with an optional swish epilogue (``F.silu(bn(x))`` or
``bn(x)``) as the hand-written kernels of ``csrc/bn_swish.cu``, for the
EfficientNet backbone's BatchNorms (``models/effnet.py``).

:func:`bn_act` takes a :class:`~challenge_tpu_torch.models.layers.BatchNorm`
module and its NCHW input. On the CPU it is the plain path itself,
``F.silu(bn(x))`` or ``bn(x)`` with autograd, so the CPU is bit for bit
what it was. On CUDA it launches the kernels or raises; there is no
fallback:

* training mode: ``bn_stats_<dt>`` (per-channel partial sums of x and
  x * x), ``bn_finalize`` (mean, mean_sq, the one-pass biased variance,
  ``mul = rsqrt(var + eps) * weight``, and the running statistics updated
  in place, in the module's own buffers, except in a remat recompute),
  then ``bn_swish_apply_<dt>`` (swish on) or ``bn_apply_<dt>``;
* eval mode: the apply alone, reading the running buffers;
* backward (a :class:`torch.autograd.Function` that saves x and a [C, 4]
  float32 vector of the statistics, where autograd's plain path saves
  three activations): ``bn_swish_grad_reduce_<dt>`` or
  ``bn_grad_reduce_<dt>`` (per-channel partial sums of dz, dz * (x -
  mean) and dz * mul), ``bn_grad_finalize`` (the weight and bias gradients
  and two per-channel coefficients), then ``bn_swish_grad_input_<dt>`` or
  ``bn_grad_input_<dt>``.

``<dt>`` is ``f32`` or ``bf16``: the input's dtype, which must be the
output's (``compute_dtype``, or float32). Inside ``layers.cross_replica``
the statistics' two means are all-reduced between the partial sums and the
finalize, as ``layers._replica_means`` does, and so are the backward's two
sums, which then feed the input gradient while the weight and bias
gradients keep this rank's share: ``bn_finalize`` and
``bn_grad_finalize`` then launch twice, around the collective.

The arithmetic follows the plain path step for step (one-pass variance,
every elementwise step rounded on its own, autograd's order of
accumulation in the backward), and a channels_last input's sums follow
ATen's reduction order, which :func:`aten_column_reduce` works out from
the shape; so a training BatchNorm on the card is the plain path's bits
(``csrc/bn_swish.cu``).
:func:`bn_act_grad_plain` is the backward's algebra in plain PyTorch ops,
held to autograd in the tests and to the kernels on the card.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from challenge_tpu_torch.ops import cuda

DTYPES = {torch.float32: 'f32', torch.bfloat16: 'bf16'}
THREADS = 256               # a channels_last reduce block, at most

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {
    'bn_stats': [_P, _P] + [_I] * 8,
    'bn_apply': [_P] * 7 + [_F] + [_I] * 7,
    'bn_grad_reduce': [_P] * 5 + [_I] * 9,
    'bn_grad_input': [_P] * 6 + [_I] * 6,
    'bn_finalize': [_P] * 7 + [_I] * 6 + [_F] * 4,
    'bn_grad_finalize': [_P] * 9 + [_I] * 5 + [_F],
}


def _run(entry: str, kind: str, count_as: str, *args) -> None:
    """Launch entry point ``entry`` of ``csrc/bn_swish.cu`` (argument types
    of ``kind``) on the current stream and count it as ``count_as``."""
    fn = getattr(cuda.load('bn_swish'), entry)
    if fn.argtypes is None:
        fn.argtypes, fn.restype = _ARGTYPES[kind] + [_P], ctypes.c_int
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f'{entry} launch failed: CUDA error {err}')
    cuda.count_launch(count_as)


def layout_of(x: torch.Tensor) -> int:
    """1 for a channels_last tensor, 0 for an NCHW-contiguous one; raises
    otherwise. A tensor that is both (H = W = 1: the two index it alike)
    is 1, as ATen reduces it: over its rows."""
    if x.is_contiguous(memory_format=torch.channels_last):
        return 1
    if x.is_contiguous():
        return 0
    raise ValueError('bn_act: the input must be contiguous, NCHW or '
                     'channels_last')


def _as_layout(t: torch.Tensor, layout: int) -> torch.Tensor:
    return t.contiguous(memory_format=torch.channels_last if layout
                        else torch.contiguous_format)


def _empty_like(x: torch.Tensor, layout: int) -> torch.Tensor:
    return torch.empty(x.shape, dtype=x.dtype, device=x.device,
                       memory_format=torch.channels_last if layout
                       else torch.contiguous_format)


def vector_width(shape, itemsize: int, layout: int) -> int:
    """The elements of a 16-byte vector where the layout's fastest axis
    (H * W for NCHW, C for channels_last) holds whole vectors, else 1."""
    b, c, h, w = shape
    n = 16 // itemsize
    return n if (h * w if layout == 0 else c) % n == 0 else 1


def _pow2(n: int, cap: int) -> int:
    """ATen's ``last_pow2(n)`` below ``cap``, else ``cap``."""
    return 1 << (n.bit_length() - 1) if n < cap else cap


def _splits(per_thread: int, grid: int, threads: int, sms: int,
            threads_per_sm: int) -> int:
    """ATen's ``ctas_per_output``: the blocks each output's inputs are
    split over, where a thread would sum 256 or more."""
    target = sms * (threads_per_sm // threads)
    if per_thread < 256 or grid > target:
        return 1
    return max(min(-(-target // grid), -(-per_thread // 16)),
               -(-per_thread // 256))


def aten_column_reduce(m: int, c: int, sms: int, threads_per_sm: int):
    """(bh, G): the block height and the splits of ATen's CUDA reduction of
    a row-major [m, c] float32 matrix over its rows, a reduction over the
    non-fastest dim (``ATen/native/cuda/Reduce.cuh``: ``setReduceConfig``
    with output vectors of 4, 2 or 1 columns, ``set_block_dimension`` with
    512 threads at most, splits across warps and blocks). Row thread y of
    split g sums rows y + bh g + k bh G; bh 1 where each thread sums all."""
    ovs = 4 if c % 4 == 0 else 2 if c % 2 == 0 else 1
    cap = 512 // ovs
    dim0 = c // ovs
    width = min(_pow2(dim0, cap), 32)
    height = min(_pow2(m, cap), cap // width)
    width = min(_pow2(dim0, cap), cap // height)
    if m < min(height * 16, 256):
        return 1, 1
    return height, _splits(-(-m // height), -(-dim0 // width),
                           width * height, sms, threads_per_sm)


def aten_plane_reduce(b: int, c: int, hw: int, sms: int,
                      threads_per_sm: int):
    """(bw, bh, G): ATen's block and splits for reducing an NCHW
    [b, c, hw] tensor over b and hw, a reduction over the fastest dims
    that do not coalesce (so not vectorized): bw lanes split each
    channel's b * hw inputs, bh rows split them further (bh 1, each row
    another channel, where a lane would sum fewer than 16 a row), G
    blocks split them again."""
    n = b * hw
    width = min(_pow2(n, 512), 32)
    height = min(_pow2(c, 512), 512 // width)
    width = min(_pow2(n, 512), 512 // height)
    if -(-n // width) < min(height * 16, 256):
        return width, 1, 1
    return width, height, _splits(-(-n // (width * height)), c,
                                  width * height, sms, threads_per_sm)


def reduce_geometry(shape, itemsize: int, layout: int, aligned: bool = True,
                    sms: int = 132, threads_per_sm: int = 2048):
    """(vec, splits, width, rows) of a reduce launch over an activation of
    ``shape`` [B, C, H, W] in ``layout``, ATen's for the same reduction on
    ``sms`` multiprocessors of ``threads_per_sm`` threads: channels_last,
    :func:`aten_column_reduce` of the [B*H*W, C] matrix, with vectors of 4
    channels where C and the pointers (``aligned``: 16-byte aligned)
    allow; NCHW, :func:`aten_plane_reduce`, one element a load."""
    b, c, h, w = shape
    if layout == 1:
        rows, splits = aten_column_reduce(b * h * w, c, sms, threads_per_sm)
        # a block holds at least one column of row threads: past 256 (an
        # odd channel count) the order is the kernels' own
        return int(aligned and c % 4 == 0), splits, 1, min(rows, THREADS)
    width, rows, splits = aten_plane_reduce(b, c, h * w, sms,
                                            threads_per_sm)
    return 0, splits, width, rows


def _inv(n: int) -> float:
    """float32(1 / n), as PyTorch's CUDA kernels divide by an integer
    scalar: a product with its float32 reciprocal."""
    return float(np.float32(1.0) / np.float32(n))


def _aligned(*ts) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in ts)


def check(bn, x: torch.Tensor) -> None:
    """Raise on what the kernels do not take: a 4-D float32 or bfloat16
    input over ``bn``'s channels at dim 1, NCHW or channels_last
    contiguous, under 2**31 elements, whose dtype is the output's
    (``compute_dtype``, else float32), with float32 parameters and buffers
    on its device, a CUDA device."""
    if x.dim() != 4:
        raise ValueError(f'bn_act: expected a 4-D NCHW input, got shape '
                         f'{tuple(x.shape)}')
    if x.dtype not in DTYPES:
        raise TypeError(f'bn_act: input dtype {x.dtype}; the kernels take '
                        'float32 and bfloat16')
    out = bn.compute_dtype or torch.promote_types(x.dtype, torch.float32)
    if out != x.dtype:
        raise TypeError(f'bn_act: input {x.dtype}, output {out}: the '
                        'kernels take one dtype for both')
    if bn.feature_dim % 4 != 1 or x.shape[1] != bn.weight.shape[0]:
        raise ValueError(f'bn_act: {bn.weight.shape[0]} features at dim '
                         f'{bn.feature_dim}, input {tuple(x.shape)}')
    layout_of(x)
    if x.numel() >= 2 ** 31:
        raise ValueError(f'bn_act: {x.numel()} elements; the kernels index '
                         'with 32 bits')
    for t in (bn.weight, bn.bias, bn.running_mean, bn.running_var):
        if t.dtype != torch.float32 or t.device != x.device \
                or not t.is_contiguous():
            raise ValueError('bn_act: parameters and buffers must be '
                             'contiguous float32 on the input\'s device')
    if x.device.type != 'cuda':
        raise ValueError(f'bn_act: the kernels take CUDA tensors, got '
                         f'{x.device}')


def bn_act(bn, x: torch.Tensor, swish: bool = True) -> torch.Tensor:
    """``F.silu(bn(x))`` (``swish``) or ``bn(x)``: the plain path on the
    CPU, the kernels on CUDA (see the module docstring)."""
    if x.device.type != 'cuda':
        y = bn(x)
        return F.silu(y) if swish else y
    from challenge_tpu_torch.models import layers
    check(bn, x)
    update = bn.training and not (layers._remat and layers._remat[1])
    return _BNAct.apply(x, bn.weight, bn.bias, bn, bool(swish), update)


def _shape(x: torch.Tensor, vec: int):
    b, c, h, w = x.shape
    return (b, c, h * w, layout_of(x), vec)


def _elementwise(x: torch.Tensor, *others):
    """The C shape arguments of an elementwise launch over ``x`` (and the
    tensors of its shape and layout ``others``)."""
    vec = int(_aligned(x, *others)
              and vector_width(x.shape, x.element_size(), layout_of(x)) > 1)
    return _shape(x, vec)


def _reduction(x: torch.Tensor, *others):
    """(the C shape arguments, then splits, width and rows) of a reduce
    launch over ``x`` (and ``others``), on ``x``'s card."""
    props = torch.cuda.get_device_properties(x.device)
    vec, *split = reduce_geometry(
        x.shape, x.element_size(), layout_of(x), _aligned(x, *others),
        props.multi_processor_count, props.max_threads_per_multi_processor)
    return _shape(x, vec) + tuple(split)


def batch_stats(bn, x: torch.Tensor, update: bool) -> torch.Tensor:
    """The [C, 4] float32 statistics (mean, mul, rs, mean_sq - mean^2) of
    the batch ``x`` (``bn_stats_<dt>``, then ``bn_finalize``), with
    ``bn``'s running statistics updated in place if ``update``. Inside
    ``layers.cross_replica`` the two means are those of the ranks' global
    batch."""
    from challenge_tpu_torch.models import layers
    args = _reduction(x)
    c, dt, splits = x.shape[1], DTYPES[x.dtype], args[5]
    partials = torch.empty((2, c, splits), dtype=torch.float32,
                           device=x.device)
    _run(f'bn_stats_{dt}', 'bn_stats', f'bn_stats_{dt}', x.data_ptr(),
         partials.data_ptr(), *args)
    stats = torch.empty((c, 4), dtype=torch.float32, device=x.device)
    # the mean's factor as PyTorch's CUDA mean forms it: C / (C N)
    factor = float(np.float32(c) / np.float32(x.numel()))
    fin = (bn.weight.data_ptr(), bn.running_mean.data_ptr(),
           bn.running_var.data_ptr(), stats.data_ptr(), c, *args[5:],
           int(update), 0, factor, float(np.float32(bn.eps)),
           float(np.float32(bn.momentum)),
           float(np.float32(1.0 - bn.momentum)))
    mesh = layers._replicas
    if mesh is None:
        _run('bn_finalize', 'bn_finalize', 'bn_finalize',
             partials.data_ptr(), None, None, *fin)
        return stats
    # (mean, mean_sq) over the ranks, as layers._replica_means forms
    # them: summed, then over the size
    means = torch.empty((2, c), dtype=torch.float32, device=x.device)
    _run('bn_finalize', 'bn_finalize', 'bn_finalize', partials.data_ptr(),
         None, means.data_ptr(), *fin)
    mesh.all_reduce_([means])
    means = means / mesh.size
    _run('bn_finalize', 'bn_finalize', 'bn_finalize', None,
         means.data_ptr(), None, *fin)
    return stats


def eval_stats(bn) -> torch.Tensor:
    """The [C, 4] statistics of ``bn``'s running buffers (``bn_finalize``
    in eval mode), for an eval-mode backward."""
    c = bn.weight.shape[0]
    stats = torch.empty((c, 4), dtype=torch.float32,
                        device=bn.weight.device)
    _run('bn_finalize', 'bn_finalize', 'bn_finalize', None, None, None,
         bn.weight.data_ptr(), bn.running_mean.data_ptr(),
         bn.running_var.data_ptr(), stats.data_ptr(), c, 0, 1, 1, 0, 1, 1.0,
         float(np.float32(bn.eps)), 0.0, 0.0)
    return stats


def normalize(bn, x: torch.Tensor, stats, swish: bool) -> torch.Tensor:
    """``bn_swish_apply_<dt>`` or ``bn_apply_<dt>``: the output, from the
    batch's ``stats`` in training mode, from the running buffers in eval
    mode (``stats`` unread, may be None)."""
    out = _empty_like(x, layout_of(x))
    shape = _elementwise(x, out)
    dt, act = DTYPES[x.dtype], 'swish_' if swish else ''
    _run(f'bn_apply_{dt}', 'bn_apply', f'bn_{act}apply_{dt}', x.data_ptr(),
         out.data_ptr(), None if stats is None else stats.data_ptr(),
         bn.running_mean.data_ptr(), bn.running_var.data_ptr(),
         bn.weight.data_ptr(), bn.bias.data_ptr(), float(np.float32(bn.eps)),
         int(not bn.training), int(swish), *shape)
    return out


def grad_sums(x, dout, stats, bias, swish: bool):
    """``bn_swish_grad_reduce_<dt>`` or ``bn_grad_reduce_<dt>``: (the [3,
    C, splits] partial sums of dz, dz * (x - mean) and dz * mul, the block
    (width, rows) that combines them)."""
    args = _reduction(x, dout)
    c, dt, act = x.shape[1], DTYPES[x.dtype], 'swish_' if swish else ''
    partials = torch.empty((3, c, args[5]), dtype=torch.float32,
                           device=x.device)
    _run(f'bn_grad_reduce_{dt}', 'bn_grad_reduce',
         f'bn_{act}grad_reduce_{dt}', x.data_ptr(), dout.data_ptr(),
         stats.data_ptr(), bias.data_ptr(), partials.data_ptr(), int(swish),
         *args)
    return partials, args[6:]


def grad_coefficients(sums, stats, weight, n: int, training: bool,
                      mesh=None):
    """``bn_grad_finalize``: (dweight, dbias, the [C, 2] coefficients
    (dvar / N, dmean / N) of the input gradient) from ``grad_sums``'
    partials over ``n`` elements a channel; on ``mesh`` the coefficients
    come from the sums over the ranks and the weight and bias gradients
    from this rank's (two launches around the all-reduce)."""
    partials, block = sums
    c, splits = partials.shape[1:]
    dweight, dbias = torch.empty_like(weight), torch.empty_like(weight)
    coef = torch.empty((c, 2), dtype=torch.float32, device=weight.device)
    tail = (stats.data_ptr(), weight.data_ptr(), dweight.data_ptr(),
            dbias.data_ptr(), coef.data_ptr(), c, splits, *block,
            int(not training),
            _inv(n * (1 if mesh is None else mesh.size)))
    if mesh is None:
        _run('bn_grad_finalize', 'bn_grad_finalize', 'bn_grad_finalize',
             partials.data_ptr(), None, None, None, *tail)
        return dweight, dbias, coef
    local = torch.empty((3, c), dtype=torch.float32, device=weight.device)
    _run('bn_grad_finalize', 'bn_grad_finalize', 'bn_grad_finalize',
         partials.data_ptr(), None, None, local.data_ptr(), *tail)
    both = local.clone()
    mesh.all_reduce_([both])
    _run('bn_grad_finalize', 'bn_grad_finalize', 'bn_grad_finalize', None,
         local.data_ptr(), both.data_ptr(), None, *tail)
    return dweight, dbias, coef


def grad_input(x, dout, stats, bias, coef, swish: bool) -> torch.Tensor:
    """``bn_swish_grad_input_<dt>`` or ``bn_grad_input_<dt>``: dx."""
    dx = _empty_like(x, layout_of(x))
    shape = _elementwise(x, dout, dx)
    dt, act = DTYPES[x.dtype], 'swish_' if swish else ''
    _run(f'bn_grad_input_{dt}', 'bn_grad_input', f'bn_{act}grad_input_{dt}',
         x.data_ptr(), dout.data_ptr(), dx.data_ptr(), stats.data_ptr(),
         bias.data_ptr(), coef.data_ptr(), int(swish), *shape)
    return dx


class _BNAct(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, weight, bias, bn, swish, update):
        from challenge_tpu_torch.models import layers
        stats = batch_stats(bn, x, update) if bn.training else None
        out = normalize(bn, x, stats, swish)
        ctx.bn, ctx.swish, ctx.training = bn, swish, bn.training
        ctx.mesh = layers._replicas if bn.training else None
        ctx.save_for_backward(x, stats, weight, bias)
        return out

    @staticmethod
    def backward(ctx, dout):
        x, stats, weight, bias = ctx.saved_tensors
        dout = dout.to(x.dtype)
        # the plain path's backward sums run over tensors laid out as the
        # gradient is: where its channels are its fastest dim, sum the rows
        # in its order, on x copied into that order
        order = row_order(dout)
        perm = None if order in (None, (0, 2, 3)) else (
            order[0], 1, order[1], order[2])
        if perm is None:
            dout = _as_layout(dout, layout_of(x))
        else:
            x, dout = x.permute(perm).contiguous(
                memory_format=torch.channels_last), dout.permute(perm)
        if stats is None:        # eval: the running buffers' statistics
            stats = eval_stats(ctx.bn)
        sums = grad_sums(x, dout, stats, bias, ctx.swish)
        dweight, dbias, coef = grad_coefficients(
            sums, stats, weight, x.numel() // x.shape[1], ctx.training,
            ctx.mesh)
        dx = grad_input(x, dout, stats, bias, coef, ctx.swish)
        if perm is not None:
            dx = dx.permute(tuple(perm.index(d) for d in range(4)))
        return dx, dweight, dbias, None, None, None


def row_order(t: torch.Tensor):
    """The dims B, H, W of a 4-D ``t`` from the slowest to the fastest in
    memory where its channels (dim 1) are its fastest dim and it is dense,
    as ATen orders the rows of a reduction over them; else None."""
    if t.stride(1) != 1:
        return None
    order = tuple(sorted((0, 2, 3), key=lambda d: -t.stride(d)))
    return order if t.permute(*order, 1).is_contiguous() else None


def _channel(v: torch.Tensor) -> torch.Tensor:
    return v.reshape(1, -1, 1, 1)


def bn_stats_plain(bn, x: torch.Tensor):
    """The per-channel (mean, mul, rs, mean_sq - mean^2) of ``bn``'s plain
    training forward on ``x`` (eval: of its running buffers), in float32 at
    least: the statistics the kernels' backward reads."""
    x = x.to(torch.promote_types(x.dtype, torch.float32))
    if bn.training:
        mean = x.mean(dim=(0, 2, 3))
        var_raw = (x * x).mean(dim=(0, 2, 3)) - mean * mean
        var = var_raw.clamp(min=0.0)
    else:
        mean, var_raw = bn.running_mean, bn.running_var
        var = var_raw
    rs = torch.rsqrt(var + bn.eps)
    return mean, rs * bn.weight, rs, var_raw


def bn_act_grad_plain(dout, x, mean, mul, rs, var_raw, weight, bias,
                      swish: bool, training: bool, out_dtype=None,
                      mesh=None):
    """The kernels' backward as plain PyTorch ops: (dx, dweight, dbias) of
    ``F.silu(bn(x))`` (``swish``) or ``bn(x)`` from its output's gradient
    ``dout``, the input ``x`` and the forward's per-channel statistics
    (:func:`bn_stats_plain`). This is autograd's algebra over the plain
    forward, in its order of accumulation, from its three per-channel sums
    (of dz, dz * (x - mean) and dz * mul). ``out_dtype`` is the forward's
    output dtype (``compute_dtype``; None: float32 at least), to which z
    and dz round as the plain path rounds them. ``mesh``: the sums over
    its ranks feed the input gradient (``layers.cross_replica``), the
    weight and bias gradients keep this rank's."""
    wide = torch.promote_types(x.dtype, torch.float32)
    out_dtype = out_dtype or wide
    xf = x.to(wide)
    d = dout.to(out_dtype).to(wide)
    y = xf - _channel(mean)
    if swish:
        z = (y * _channel(mul) + _channel(bias)).to(out_dtype).to(wide)
        s = torch.sigmoid(z)
        d = (d * s * (1 + z * (1 - s))).to(out_dtype).to(wide)
    axes = (0, 2, 3)
    dz_mul = d * _channel(mul)
    sums = torch.stack([d.sum(dim=axes), (d * y).sum(dim=axes),
                        dz_mul.sum(dim=axes)])
    dbias, dweight = sums[0], sums[1] * rs
    n = x.numel() // x.shape[1]
    if not training:
        return dz_mul.to(x.dtype), dweight, dbias
    if mesh is not None:
        sums = sums.clone()
        mesh.all_reduce_([sums])
        n *= mesh.size
    dvar = torch.where(var_raw >= 0, -0.5 * (sums[1] * weight) * rs.pow(3),
                       torch.zeros_like(rs))
    t = -dvar * mean
    dmean = (-sums[2] + t) + t
    g = _channel(dvar / n) * xf
    dx = ((dz_mul + g) + g) + _channel(dmean / n)
    return dx.to(x.dtype), dweight, dbias


def expected_launches(n_swish: int, n_plain: int, dt: str = 'f32',
                      train_steps: int = 1, eval_steps: int = 0) -> dict:
    """The launches, by counter name, of ``train_steps`` training steps
    (forward and backward, no remat) and ``eval_steps`` eval forwards of a
    model with ``n_swish`` BatchNorms followed by swish and ``n_plain``
    without, all through :func:`bn_act` on one device (``dt`` ``'f32'`` or
    ``'bf16'``; on a mesh each finalize launches twice)."""
    out: dict = {}
    for n, act in ((n_swish, 'swish_'), (n_plain, '')):
        for name, steps in (
                (f'bn_stats_{dt}', train_steps), ('bn_finalize', train_steps),
                (f'bn_{act}apply_{dt}', train_steps + eval_steps),
                (f'bn_{act}grad_reduce_{dt}', train_steps),
                ('bn_grad_finalize', train_steps),
                (f'bn_{act}grad_input_{dt}', train_steps)):
            out[name] = out.get(name, 0) + n * steps
    return {k: v for k, v in out.items() if v}
