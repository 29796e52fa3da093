"""The port's counterpart of ``__graft_entry__.py``
(challenge_tpu_torch/dryrun.py) and the mesh at 3, 4 and 8 ranks.

``shard_banks`` over 3, 4 and 8 ranks is held block for block, exactly,
to JAX's over ``make_mesh(W)`` of the 8 host devices, on the dryrun's
banks (3 backgrounds, 4 voices, 3 noises) and on ``small_sources(1)``.
``entry`` has JAX's config and input shape, and its forward equals the
module's own. ``dryrun_multichip`` runs on 3 CPU ranks here (its own
checks: every rank's weights and metrics equal after each part, the eval
equal to one process's), and on 8 as a slow test, the mirror of
tests/test_parallel.py::test_graft_entry_contract. A CPU rank is pinned
to one torch thread, so that 8 ranks do not oversubscribe the host.
"""

import importlib.util
import math
import os
import time

import numpy as np
import pytest
import torch

from _torch_parity import small_sources
from challenge_tpu_torch import dryrun
from challenge_tpu_torch.models.registry import get_model
from challenge_tpu_torch.parallel import launch
from challenge_tpu_torch.parallel import mesh as mesh_lib
from test_torch_mesh import check_shard_banks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope='module', autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _graft_entry():
    spec = importlib.util.spec_from_file_location(
        '__graft_entry__', os.path.join(REPO, '__graft_entry__.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize('size', [3, 4, 8])
@pytest.mark.parametrize('dtype', ['float32', 'int8'])
@pytest.mark.parametrize('which', ['dryrun', 'small'])
def test_shard_banks_places_what_jax_places_over_more_ranks(which, dtype,
                                                            size):
    """Each device's block equals JAX's, the cyclic padding included: the
    dryrun's 3/4/3 items become 3/6/3, 4/4/4 or 8/8/8; small_sources'
    3/5/3 become 3/6/3, 4/8/4 or 8/8/8."""
    sources = (dryrun._sources(np.random.default_rng(0)) if which == 'dryrun'
               else small_sources(1))
    pb = check_shard_banks(sources, dtype, size)
    got = mesh_lib.shard_banks(pb, mesh_lib.Mesh(('cpu',) * size, 0))
    for bank, items in zip((got.backgrounds, got.voices, got.noises),
                           (sources[0], sources[1], sources[3])):
        assert bank.n == -(-len(items) // size)


def test_entry_is_jax_entry_on_the_port(monkeypatch):
    """The config, input shape and parameter count of JAX's ``entry()``
    (its model built, not initialised: shapes only), and a finite forward
    equal to the module's own eval-mode forward bit for bit."""
    import jax
    from challenge_tpu import models as jmodels
    from _torch_parity import shape_bundle
    seen = []
    real = jmodels.get_model

    def recording(cfg):
        seen.append(cfg)
        return shape_bundle(real(cfg))
    monkeypatch.setattr(jmodels, 'get_model', recording)
    _, (jvars, jx) = _graft_entry().entry()
    (jcfg,) = seen
    fn, (variables, x) = dryrun.entry('cpu')
    cfg = dryrun.ENTRY_CONFIG
    for field in ('model_type', 'v', 'n_mels', 'n_frame', 'n_chan',
                  'batch_size'):
        assert getattr(cfg, field) == getattr(jcfg, field), field
    assert tuple(x.shape) == tuple(jx.shape) and x.dtype == torch.float32
    n_params = sum(math.prod(a.shape)
                   for a in jax.tree.leaves(jvars['params']))
    module = get_model(cfg, 'cpu', seed=0).module.eval()
    assert sum(p.numel() for p in module.parameters()) == n_params
    out = fn(variables, x)
    assert out.shape == (12, 16, 3) and torch.isfinite(out).all()
    with torch.no_grad():
        torch.testing.assert_close(out, module(x), rtol=0, atol=0)


@pytest.mark.parametrize('fails', [None, 5])
def test_eight_cpu_ranks_meet_and_a_failing_rank_fails_the_run(tmp_path,
                                                                fails):
    """8 ranks through one ``file://`` rendezvous: each returns its rank;
    with rank 5 raising mid-run while the others wait in a collective,
    ``launch.run`` raises at once, naming it, and nothing is left."""
    t0 = time.monotonic()
    if fails is None:
        assert launch.run('_torch_mesh:fail_on', (99,), ['cpu'] * 8,
                          workdir=str(tmp_path)) == list(range(8))
    else:
        with pytest.raises(RuntimeError, match='rank 5 exited with code 1'):
            launch.run('_torch_mesh:fail_on', (fails,), ['cpu'] * 8,
                       workdir=str(tmp_path))
    assert time.monotonic() - t0 < 60
    assert mesh_lib.current() is None
    assert not list(tmp_path.iterdir())


def _check_report(report, size: int) -> None:
    assert report['ranks'] == size and report['backend'] == 'gloo'
    # on the CPU every wrapper runs its plain version: no launch
    assert report['launches'] == [{p: {} for p in dryrun.PARTS}] * size
    m = report['metrics']
    for part in ('fused', 'capacity', 'int8', 'se'):
        assert np.isfinite(m[part]['loss'])
    assert len(m['stream']) == 2 and np.isfinite(m['stream'][-1]['loss'])
    assert len(m['eval']['ers']) == 2
    assert all(np.isfinite(e) for e in m['eval']['ers'])


def test_dryrun_multichip_on_three_cpu_ranks():
    _check_report(dryrun.dryrun_multichip(3, device='cpu'), 3)


@pytest.mark.slow
def test_dryrun_multichip_contract_on_eight_cpu_ranks():
    """``entry()``'s forward is finite, and ``dryrun_multichip(8)`` runs
    every part on 8 ranks (JAX's test_graft_entry_contract)."""
    fn, args = dryrun.entry('cpu')
    assert torch.isfinite(fn(*args)).all()
    _check_report(dryrun.dryrun_multichip(8, device='cpu'), 8)


def test_entry_points_raise_without_a_card():
    """No card and no ``device='cpu'``: both raise, never fall back."""
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dryrun.entry()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dryrun.dryrun_multichip(2)
