"""The fused training step of ``challenge_tpu_torch`` (parallel/train.py,
train/state.py, train/loop.py) against ``challenge_tpu``'s, on the CPU,
where the step runs eager (its plain version; the CUDA graph of the step
runs only on the card, in chip_smoke.py's phase 5g).

* ``grad_accum``: k = 3 microbatches made with numpy, gradients summed in
  order and divided by 3, BN statistics threaded, then one update,
  against JAX's ``make_grad_update`` composed the same way
  (tests/test_parallel.py:182-231, with Adam), both in float64 (ROADMAP
  C2): parameters and BN statistics within 1e-5 (absolute), the mean loss
  at rtol 1e-6.
* ``remat``: JAX's remat step against the port's in float64, parameters
  within 1e-5; and the port's remat step against its own step without
  remat, bit for bit (gradients, update, BN statistics, the
  stochastic-depth generator), on vad v8, eff B0 and the se cascade. A
  plain ``torch.utils.checkpoint`` repeats the forward's effects (ROADMAP
  C11, C12); the port's does not.
* ``steps_per_call``: bit for bit against single calls, JAX's ceil of
  calls per epoch and its mean of call means for the logs.
* the optimizer's device learning rate and step count against the
  Python-scalar form the port had before, bit for bit; the callbacks
  write the rate in place.
* routing: iterator mode refuses ``grad_accum`` as JAX does, the density
  trainer's ``--grad_accum`` trains in banks mode, and both CLIs accept
  the three flags.

Models are shrunk (vad v8 at base 8 and td_dim 32, eff B0 on 32 mels x 64
frames); the se cascade's widths are fixed, so it runs at full width on
batch 2 x 32 frames.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from _helpers import DATA_FLAGS, make_datafiles
from _torch_parity import N_FRAME, N_MELS, small_sources, vad_variables
from challenge_tpu.config import Config as JConfig
from challenge_tpu.models.registry import ModelBundle as JBundle
from challenge_tpu.models.vad import VADModel as JVADModel
from challenge_tpu.train import callbacks as jcb
from challenge_tpu.train import optim as joptim
from challenge_tpu.train.state import TrainState as JState
from challenge_tpu.train.state import make_grad_update as jax_grad_update
from challenge_tpu_torch.cli import sj_train, trainer
from challenge_tpu_torch.config import Config
from challenge_tpu_torch.data.pipeline import DevicePipeline, build_banks
from challenge_tpu_torch.interop.jax_weights import flax_to_state_dict
from challenge_tpu_torch.models import layers
from challenge_tpu_torch.models.registry import ModelBundle, get_model
from challenge_tpu_torch.models.vad import VADModel
from challenge_tpu_torch.parallel import (
    FusedTrainStep, make_fused_eval_step, make_fused_train_step)
from challenge_tpu_torch.train import callbacks as cb
from challenge_tpu_torch.train.loop import TrainLoop
from challenge_tpu_torch.train.optim import (
    AdaBelief, KerasAdam, bias_correction, make_optimizer)
from challenge_tpu_torch.train.state import (
    TrainState, accumulate_grads, make_grad_update)

SHAPE = (N_MELS, N_FRAME, 2)
CFG = dict(model_type='vad', v=8, n_mels=N_MELS, n_frame=N_FRAME,
           batch_size=2)
K = 3


def _batches(seed, n, batch=2):
    """n (log-mel-like x, 0/1 labels at 1/32 of the frames) from numpy."""
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((batch,) + SHAPE),
             rng.integers(0, 2, (batch, N_FRAME // 32, 3)).astype(float))
            for _ in range(n)]


def _f64(tree):
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree)


_JAX = {}     # compiled float64 JAX steps, shared by the tests


def _jax_fns(remat):
    """(jit grad_fn, jit update_fn, optimizer) of JAX's vad v8 in float64;
    the update does not depend on remat, so one is compiled."""
    if remat not in _JAX:
        with jax.enable_x64(True):
            jm = JVADModel(v=8, base_fsize=8, td_dim=32, dtype=jnp.float64)
            grad_fn, update_fn, opt = jax_grad_update(
                JBundle(jm, SHAPE, JConfig(**CFG, remat=remat)))
            other = _JAX.get(not remat)
            update = other[1] if other else jax.jit(update_fn)
            _JAX[remat] = (jax.jit(grad_fn), update, opt)
    return _JAX[remat]


def _jax_f64_step(variables, batches, remat=False):
    """JAX's make_grad_update over ``batches`` as one accumulated step
    (parallel/train.py:188-208), in float64; returns (state, losses)."""
    grad_fn, update_fn, opt = _jax_fns(remat)
    with jax.enable_x64(True):
        v = _f64(variables)
        params, stats = v['params'], v['batch_stats']
        state = JState(step=jnp.zeros([], jnp.int32), params=params,
                       batch_stats=stats, opt_state=opt.init(params),
                       swa_params=params, swa_batch_stats=stats,
                       swa_count=jnp.zeros([], jnp.int32))
        total, losses = None, []
        for i, batch in enumerate(batches):
            g, stats, m = grad_fn(params, stats, _f64(batch),
                                  jax.random.PRNGKey(i))
            total = g if total is None else jax.tree.map(jnp.add, total, g)
            losses.append(float(m['loss']))
        grads = jax.tree.map(lambda g: g / len(batches), total)
        state = update_fn(state, grads, stats)
        return jax.device_get(state), losses


def _port_f64_step(variables, batches, remat=False):
    """The port's accumulated step over ``batches`` in float64; returns
    (module, metrics)."""
    pm = VADModel(v=8, base_fsize=8, td_dim=32, n_mels=N_MELS)
    pm.load_state_dict(flax_to_state_dict(variables), strict=True)
    pm = pm.double()
    bundle = ModelBundle(pm, SHAPE, Config(**CFG, remat=remat),
                         torch.device('cpu'))
    state = TrainState(pm, make_optimizer(bundle.config, pm.parameters()))
    grad_fn, update_fn = make_grad_update(bundle)
    tensors = ((torch.from_numpy(x), torch.from_numpy(y))
               for x, y in batches)
    grads, metrics = accumulate_grads(grad_fn, pm, tensors)
    update_fn(state, grads)
    assert state.step == 1
    return pm, metrics


def _running_mean(module):
    """The first BN's running mean, a copy."""
    return next(b for n, b in module.named_buffers()
                if n.endswith('running_mean')).clone()


def _assert_state_matches(pm, jstate):
    ref = flax_to_state_dict({'params': jstate.params,
                              'batch_stats': jstate.batch_stats})
    sd = pm.state_dict()
    assert set(ref) == set(sd)
    for k, v in ref.items():
        np.testing.assert_allclose(sd[k].numpy(), v.numpy(), rtol=0,
                                   atol=1e-5, err_msg=k)


@pytest.fixture(scope='module', autouse=True)
def _two_torch_threads():
    """As tests/test_torch_se.py: on every core, the full-width se U-Net
    oversubscribes the CPU when the suite runs in several workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def variables():
    return vad_variables(JVADModel(v=8, base_fsize=8, td_dim=32), SHAPE,
                         seed=3)


# ---------------------------------------------------------- grad_accum
def test_grad_accum_matches_jax_in_float64(variables):
    """3 microbatches, one update: parameters and BN statistics (threaded
    through the 3 forwards) within 1e-5, the mean loss at rtol 1e-6."""
    batches = _batches(0, K)
    jstate, losses = _jax_f64_step(variables, batches)
    pm, metrics = _port_f64_step(variables, batches)
    _assert_state_matches(pm, jstate)
    np.testing.assert_allclose(float(metrics['loss']), np.mean(losses),
                               rtol=1e-6)
    # the statistics moved 3 times: not as after one forward
    one, _ = _port_f64_step(variables, batches[:1])
    assert not torch.equal(_running_mean(one), _running_mean(pm))


def test_accumulation_sums_in_order_then_divides():
    """The gradients are ((g1 + g2) + g3) / 3, a division as JAX's, and
    each metric is the mean over the microbatches."""
    g = [torch.tensor([1.0, 2.0 ** -24]), torch.tensor([2.0 ** -24, 3.0]),
         torch.tensor([1e-3, 7.0])]

    def grad_fn(module, batch, gen=None):
        return (g[batch],), {'loss': torch.tensor(float(batch))}

    grads, metrics = accumulate_grads(grad_fn, None, range(3))
    assert torch.equal(grads[0], ((g[0] + g[1]) + g[2]) / 3)
    assert float(metrics['loss']) == 1.0
    grads, metrics = accumulate_grads(grad_fn, None, [2])
    assert grads[0] is g[2] and float(metrics['loss']) == 2.0


# --------------------------------------------------------------- remat
def test_remat_step_matches_jax_remat_in_float64(variables):
    """tests/test_train.py:291 across the packages: JAX's remat step and
    the port's remat step from one init on one batch, float64, within
    1e-5."""
    batches = _batches(1, 1)
    jstate, _ = _jax_f64_step(variables, batches, remat=True)
    pm, _ = _port_f64_step(variables, batches, remat=True)
    _assert_state_matches(pm, jstate)


def _vad_bundle(remat):
    pm = VADModel(v=8, base_fsize=8, td_dim=32, n_mels=N_MELS)
    bundle = ModelBundle(pm, SHAPE, Config(**CFG, remat=remat),
                         torch.device('cpu'))
    bundle.init(5)
    x, y = _batches(2, 1)[0]
    return bundle, (torch.from_numpy(x).float(), torch.from_numpy(y).float())


def _eff_bundle(remat):
    cfg = Config(model_type='eff', model=0, v=3, n_mels=N_MELS,
                 n_frame=N_FRAME, batch_size=2, remat=remat)
    x, y = _batches(3, 1)[0]
    return get_model(cfg, device='cpu', seed=4), (
        torch.from_numpy(x).float(), torch.from_numpy(y).float())


def _se_bundle(remat):
    cfg = Config(model_type='se', v=9, n_frame=32, batch_size=2,
                 pretrain=True, remat=remat)
    banks = build_banks(*small_sources(2), n_frame=32, device='cpu')
    batch = next(iter(DevicePipeline(banks, cfg, device='cpu', seed=6)))
    return get_model(cfg, device='cpu', seed=6), batch


def _step(bundle, batch, gen):
    """One port step; returns (grads, metrics, state_dict, optimizer)."""
    state = TrainState(bundle.module, make_optimizer(
        bundle.config, bundle.module.parameters()))
    grad_fn, update_fn = make_grad_update(bundle)
    grads, metrics = grad_fn(bundle.module, batch, gen)
    update_fn(state, [g.clone() for g in grads])
    return grads, metrics, copy.deepcopy(bundle.module.state_dict()), \
        state.optimizer


@pytest.mark.parametrize('family', ['vad_v8', 'eff_b0', 'se'])
def test_remat_equals_the_step_without_remat(family):
    """The remat step (checkpointed forward and loss, the forward run again
    in the backward) equals the step without it exactly: gradients,
    metrics, the updated weights and BN statistics, Adam's moments, and
    the stochastic-depth generator's state after the step."""
    make = {'vad_v8': _vad_bundle, 'eff_b0': _eff_bundle,
            'se': _se_bundle}[family]
    runs = []
    for remat in (False, True):
        bundle, batch = make(remat)
        gen = torch.Generator().manual_seed(9)
        grads, metrics, sd, opt = _step(bundle, batch,
                                        gen if bundle.needs_dropout_gen
                                        else None)
        runs.append((grads, metrics, sd, opt, gen.get_state()))
    (g0, m0, sd0, o0, r0), (g1, m1, sd1, o1, r1) = runs
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    assert all(torch.equal(m0[k], m1[k]) for k in m0)
    assert all(torch.equal(sd0[k], sd1[k]) for k in sd0)
    for s0, s1 in zip(o0.state.values(), o1.state.values()):
        assert torch.equal(s0['m'], s1['m']) and torch.equal(s0['v'],
                                                             s1['v'])
    assert torch.equal(r0, r1)
    if family == 'eff_b0':     # stochastic depth drew from the generator
        assert not torch.equal(r0, torch.Generator().manual_seed(
            9).get_state())


@pytest.mark.parametrize('fault', ['C11_bn_statistics', 'C12_keep_masks'])
def test_plain_checkpoint_repeats_the_forward_effects(fault):
    """ROADMAP C11, C12: under a plain ``torch.utils.checkpoint`` the
    recompute moves the BN running statistics a second time (C11) and
    draws new keep masks, advancing the generator twice (C12);
    ``layers.remat_contexts`` keeps both to the first pass."""
    bundle, (x, y) = (_vad_bundle if fault.startswith('C11')
                      else _eff_bundle)(False)
    module = bundle.module.train()
    init = copy.deepcopy(module.state_dict())

    def after(**kw):
        module.load_state_dict(init)
        gen = torch.Generator().manual_seed(9)
        args = (gen,) if bundle.needs_dropout_gen else ()
        out = checkpoint(lambda t: module(t, *args).sum(), x,
                         use_reentrant=False, preserve_rng_state=False, **kw)
        out.backward()
        return _running_mean(module), gen.get_state()

    plain, ported = after(), after(context_fn=layers.remat_contexts)
    with torch.no_grad():
        module.load_state_dict(init)
        gen = torch.Generator().manual_seed(9)
        module(x, gen) if bundle.needs_dropout_gen else module(x)
        once = (_running_mean(module), gen.get_state())
    which = 0 if fault.startswith('C11') else 1
    assert not torch.equal(plain[which], once[which])
    assert torch.equal(ported[0], once[0]) and torch.equal(ported[1],
                                                           once[1])


# ------------------------------------------------------- steps_per_call
def _banks_loop(seed=0, variant='sj', **kw):
    cfg = Config(**CFG, **kw)
    banks = build_banks(*small_sources(1), n_frame=N_FRAME, device='cpu')
    bundle = ModelBundle(VADModel(v=8, base_fsize=8, td_dim=32,
                                  n_mels=N_MELS), SHAPE, cfg,
                         torch.device('cpu'))
    return TrainLoop(bundle, seed=seed, banks=banks, val_banks=banks,
                     variant=variant)


def test_steps_per_call_2_trains_as_single_calls():
    """4 steps an epoch as 2 calls of 2 or 4 calls of 1: the same weights,
    BN statistics and step count, bit for bit."""
    a, b = _banks_loop(steps_per_call=1), _banks_loop(steps_per_call=2)
    for loop in (a, b):
        loop.fit(epochs=1, steps_per_epoch=4, validation_steps=0, verbose=0)
    assert a.state.step == b.state.step == 4
    wa, wb = a.get_weights(), b.get_weights()
    assert all(torch.equal(wa[k], wb[k]) for k in wa)


def test_steps_per_call_rounds_each_epoch_up_to_whole_calls():
    """3 steps an epoch with 2 steps a call: 2 calls, 4 optimizer steps a
    epoch (loop.py:97-108, 147-160)."""
    loop = _banks_loop(steps_per_call=2)
    assert loop.steps_per_fused_epoch(3) == 4
    assert loop.steps_per_fused_epoch(4) == 4
    assert loop.steps_per_fused_epoch(0) == 2
    loop.fit(epochs=2, steps_per_epoch=3, validation_steps=1, verbose=0)
    assert loop.state.step == 2 * loop.steps_per_fused_epoch(3) == 8
    assert _banks_loop().steps_per_fused_epoch(3) == 3


def test_logs_are_the_mean_of_each_calls_mean(monkeypatch):
    """A call's metrics are the mean over its steps, and the epoch's logs
    the mean over its calls, as JAX's run_epoch takes them."""
    steps, calls = [], []
    one, call = FusedTrainStep.one, FusedTrainStep.__call__

    def record_one(self, *a):
        steps.append({k: v.clone() for k, v in one(self, *a).items()})
        return steps[-1]

    def record_call(self, *a):
        calls.append(call(self, *a))
        return calls[-1]

    monkeypatch.setattr(FusedTrainStep, 'one', record_one)
    monkeypatch.setattr(FusedTrainStep, '__call__', record_call)
    loop = _banks_loop(steps_per_call=2)
    logs = loop.fit(epochs=1, steps_per_epoch=3, validation_steps=0,
                    verbose=0)[0]
    assert len(steps) == 4 and len(calls) == 2
    for i, c in enumerate(calls):
        for k in ('loss', 'er'):
            assert torch.equal(c[k], torch.stack(
                [steps[2 * i][k], steps[2 * i + 1][k]]).mean(0))
    assert logs['loss'] == float(calls[0]['loss'] + calls[1]['loss']) / 2
    assert logs['er'] == float(calls[0]['er'] + calls[1]['er']) / 2


def test_banks_mode_trains_with_all_three_and_the_plain_version():
    """grad_accum 2, steps_per_call 2 and remat in one loop: 2 calls of 2
    steps of 2 microbatches; the fused step's plain version from the same
    generators gives the same weights."""
    loop = _banks_loop(grad_accum=2, steps_per_call=2, remat=True)
    ref = _banks_loop(grad_accum=2, steps_per_call=2)
    grads_seen = []
    grad_fn = loop.train_step.grad_fn
    loop.train_step.grad_fn = lambda *a: grads_seen.append(1) or grad_fn(*a)
    logs = loop.fit(epochs=1, steps_per_epoch=4, validation_steps=1,
                    verbose=0)[0]
    assert loop.state.step == 4 and len(grads_seen) == 8
    assert np.isfinite(logs['loss']) and np.isfinite(logs['val_loss'])
    gen = ref.phase_gen(0, True)
    for _ in range(2):
        ref.train_step.plain(ref.state, ref.banks, gen)
    wa, wb = loop.get_weights(), ref.get_weights()
    assert all(torch.equal(wa[k], wb[k]) for k in wa)


def test_fused_steps_take_a_mesh_with_jax_s_errors():
    """Once refused (ROADMAP A14): on a mesh of 2 the fused steps draw each
    rank's share of the batch; sharded banks without a mesh, or with a
    batch the mesh does not divide, raise JAX's ValueErrors."""
    from challenge_tpu.parallel import mesh as jmesh
    from challenge_tpu.parallel import train as jtrain
    from challenge_tpu_torch.parallel.mesh import Mesh
    bundle = _banks_loop().bundle
    mesh = Mesh(('cpu', 'cpu'), rank=1)
    odd = Config(**dict(CFG, batch_size=3))
    jbundle = JBundle(JVADModel(v=8, base_fsize=8, td_dim=32), SHAPE,
                      JConfig(**dict(CFG, batch_size=3)))
    jmesh_2 = jmesh.make_mesh(2)
    for make, jmake in ((make_fused_train_step, jtrain.make_fused_train_step),
                        (make_fused_eval_step, jtrain.make_fused_eval_step)):
        step = make(bundle, bundle.config, mesh=mesh, bank_sharded=True)
        assert step.features.config.batch_size == CFG['batch_size'] // 2
        for kw, jkw, config in (
                (dict(bank_sharded=True), dict(bank_sharded=True),
                 bundle.config),
                (dict(mesh=mesh, bank_sharded=True),
                 dict(mesh=jmesh_2, bank_sharded=True), odd)):
            with pytest.raises(ValueError) as ref:
                jmake(jbundle, jbundle.config, **jkw)
            with pytest.raises(ValueError) as got:
                make(bundle, config, **kw)
            assert str(got.value) == str(ref.value)


# ------------------------------------------------------------ optimizer
class _ScalarKerasAdam(torch.optim.Optimizer):
    """The port's Keras Adam and AdaBelief as they were with a Python-int
    step count, a Python-float learning rate and the correction from
    numpy's float32."""

    def __init__(self, params, lr, clipvalue, belief=False):
        super().__init__(params, dict(lr=lr, clipvalue=clipvalue))
        self.belief = belief

    @torch.no_grad()
    def step(self):
        b1, b2 = 0.9, 0.999
        for group in self.param_groups:
            for p in group['params']:
                g = p.grad.clamp(-group['clipvalue'], group['clipvalue'])
                s = self.state[p]
                if not s:
                    s.update(step=0, m=torch.zeros_like(p),
                             v=torch.zeros_like(p))
                s['step'] += 1
                t = np.float32(s['step'])
                corr = float(np.sqrt(np.float32(1) - np.float32(b2) ** t)
                             / (np.float32(1) - np.float32(b1) ** t))
                s['m'].mul_(b1).add_((1 - b1) * g)
                d = (g - s['m']) if self.belief else g
                s['v'].mul_(b2).add_((1 - b2) * d.square())
                p.add_(corr * s['m'] / (s['v'].sqrt() + 1e-7)
                       * -group['lr'])


@pytest.mark.parametrize('opt', [KerasAdam, AdaBelief])
def test_device_lr_and_step_equal_the_scalar_form(opt):
    """5 steps with a learning-rate change after the third, from the same
    gradients: moments and parameters bit for bit."""
    rng = np.random.default_rng(4)
    init = rng.standard_normal((6, 5)).astype(np.float32)
    grads = [rng.standard_normal((6, 5)).astype(np.float32) * 0.02
             for _ in range(5)]
    p, q = (torch.nn.Parameter(torch.from_numpy(init.copy()))
            for _ in range(2))
    new = opt([p], lr=1e-3, clipvalue=0.01)
    old = _ScalarKerasAdam([q], lr=1e-3, clipvalue=0.01,
                           belief=opt is AdaBelief)
    for i, g in enumerate(grads):
        if i == 3:
            new.param_groups[0]['lr'].fill_(3e-4)
            old.param_groups[0]['lr'] = 3e-4
        p.grad, q.grad = torch.from_numpy(g), torch.from_numpy(g)
        new.step()
        old.step()
    assert int(new.param_groups[0]['step']) == 5
    assert torch.equal(new.state[p]['m'], old.state[q]['m'])
    assert torch.equal(new.state[p]['v'], old.state[q]['v'])
    assert torch.equal(p, q)


def test_bias_correction_is_the_float32_ieee_chain():
    """The correction of steps 1 to 3,000 equals numpy's scalar float32
    sqrt(1 - b2^t) / (1 - b1^t) bit for bit (numpy's vectorised float32
    power is not correctly rounded, so the reference is taken a scalar at
    a time, as the port's optimizer took it before)."""
    steps = torch.arange(1, 3001)
    got = torch.stack([bias_correction(t, 0.9, 0.999) for t in steps])
    b1, b2, one = np.float32(0.9), np.float32(0.999), np.float32(1)
    ref = [np.sqrt(one - b2 ** np.float32(t)) / (one - b1 ** np.float32(t))
           for t in range(1, 3001)]
    np.testing.assert_array_equal(got.numpy(), np.array(ref, np.float32))


def test_callbacks_write_the_device_lr_in_place():
    """LearningRateScheduler and ReduceLROnPlateau fill the optimizer's
    own lr tensor, which a captured step reads, with the values JAX's
    callbacks set."""
    opt = KerasAdam([torch.nn.Parameter(torch.zeros(2))], lr=1e-3)
    lr = opt.param_groups[0]['lr']
    loop = type('Loop', (), {})()
    loop.state = TrainState(torch.nn.Linear(1, 1), opt)
    sched = cb.LearningRateScheduler(lambda e: 1e-3 / (e + 1))
    plateau = cb.ReduceLROnPlateau(monitor='loss', factor=0.9, patience=1)
    jplateau = jcb.ReduceLROnPlateau(monitor='loss', factor=0.9, patience=1)
    jopt = joptim.make_optimizer(JConfig(optimizer='adam', lr=0.5))
    jloop = type('Loop', (), {})()
    jloop.state = JState(step=0, params={}, batch_stats={},
                         opt_state=jopt.init({'w': jnp.zeros(2)}),
                         swa_params={}, swa_batch_stats={}, swa_count=0)
    for c in (sched, plateau):
        c.set_loop(loop)
    jplateau.set_loop(jloop)
    sched.on_epoch_begin(3)
    assert opt.param_groups[0]['lr'] is lr
    assert float(lr) == np.float32(1e-3 / 4)
    lr.fill_(0.5)
    for epoch, loss in enumerate([1.0, 2.0, 3.0]):
        plateau.on_epoch_end(epoch, {'loss': loss})
        jplateau.on_epoch_end(epoch, {'loss': loss})
    assert opt.param_groups[0]['lr'] is lr
    assert float(lr) == float(
        jloop.state.opt_state.hyperparams['learning_rate']) != 0.5


# -------------------------------------------------------------- routing
def test_iterator_mode_refuses_grad_accum():
    """tests/test_parallel.py:252: batches that arrive one at a time cannot
    be accumulated inside the step."""
    bundle = _banks_loop().bundle
    bundle.config = bundle.config.replace(grad_accum=2)
    with pytest.raises(ValueError, match='grad_accum'):
        TrainLoop(bundle)
    loop = TrainLoop(bundle.__class__(
        bundle.module, SHAPE, bundle.config.replace(grad_accum=1,
                                                    steps_per_call=4),
        bundle.device))
    assert loop.steps_per_call == 1 and not loop.fused


DENSITY_ARGV = ['--name', 'dens', '--model', 'EfficientNetB0', '--n_chan',
                '2', '--n_mels', str(N_MELS), '--n_frame', str(N_FRAME),
                '--batch_size', '2', '--epochs', '2', '--steps_per_epoch',
                '2', '--device', 'cpu']


def test_trainer_grad_accum_trains_in_banks_mode(tmp_path, monkeypatch):
    """tests/test_cli.py:295: ``--grad_accum 2`` trains the density model
    in banks mode, one optimizer step per 2 microbatches, with remat and 2
    steps a call, and writes its checkpoints."""
    monkeypatch.chdir(tmp_path)
    make_datafiles(tmp_path)
    loops, micro = [], []
    init = TrainLoop.__init__

    def keep(self, *a, **kw):
        init(self, *a, **kw)
        loops.append(self)
        if self.fused:
            grad_fn = self.train_step.grad_fn
            self.train_step.grad_fn = \
                lambda *g: micro.append(1) or grad_fn(*g)

    monkeypatch.setattr(TrainLoop, '__init__', keep)
    trainer.main(DENSITY_ARGV + ['--grad_accum', '2', '--steps_per_call',
                                 '2', '--remat', 'True', '--datapath',
                                 str(tmp_path)] + DATA_FLAGS)
    (loop,) = loops
    assert loop.fused and loop.train_step.features.density
    assert loop.state.step == 4 and len(micro) == 8
    assert (tmp_path / 'dens.h5').exists()
    assert (tmp_path / 'dens_SWA.h5').exists()


def test_sj_train_takes_the_three_flags(tmp_path, monkeypatch):
    """``--steps_per_call 2 --grad_accum 2 --remat True`` reach the loop,
    which trains its 1-step epoch as one call of 2 steps on the CPU."""
    monkeypatch.chdir(tmp_path)
    make_datafiles(tmp_path)
    loops = []
    init = TrainLoop.__init__
    monkeypatch.setattr(TrainLoop, '__init__', lambda self, *a, **kw: (
        init(self, *a, **kw), loops.append(self))[0])
    sj_train.main(['--model_type', 'vad', '--v', '3', '--n_mels',
                   str(N_MELS), '--n_frame', str(N_FRAME), '--batch_size',
                   '2', '--epochs', '1', '--steps_per_epoch', '1',
                   '--steps_per_call', '2', '--grad_accum', '2', '--remat',
                   'True', '--device', 'cpu'] + DATA_FLAGS)
    (loop,) = loops
    assert loop.config.remat and loop.train_step.grad_accum == 2
    assert loop.state.step == 2
