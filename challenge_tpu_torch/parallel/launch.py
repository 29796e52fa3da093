"""Starting the ranks of a mesh.

:func:`run` calls a function in every rank of a mesh and returns what each
rank returned. The calling process is rank 0; ranks 1..k-1 are child
processes (``python -m challenge_tpu_torch.parallel.launch DIR``) that
import the function by name. They meet through a ``file://`` rendezvous in
a temporary directory, so concurrent runs never contend for a port. The
process group is ``nccl`` when every rank has a card of its own and
``gloo`` otherwise (the CPU, or ranks that share a card).

There is no fallback. A rank that raises or dies makes :func:`run` raise:
rank 0 sees its own exception, or a collective fails when a peer's
connection closes, and then every other rank is killed. A child that dies
before it reaches the rendezvous is seen at once, and no rank waits on a
peer longer than the mesh's timeout (``parallel.mesh.TIMEOUT``).

The training CLIs call :func:`run` where the device policy gives a mesh.
A process that ``torchrun`` started joins its ranks instead
(``parallel.mesh.mesh_for_config``).
"""

from __future__ import annotations

import importlib
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path
from typing import Any, List, Sequence

import torch

from challenge_tpu_torch.parallel import mesh as mesh_lib


def _resolve(target: str):
    """``'package.module:function'`` -> the function."""
    module, _, name = target.partition(':')
    fn = importlib.import_module(module)
    for part in name.split('.'):
        fn = getattr(fn, part)
    return fn


def _wait_ready(procs, rundir: Path, timeout: float) -> None:
    """Wait until every child has reached the rendezvous; raise if one
    exits first or the timeout passes."""
    deadline = time.monotonic() + timeout
    for rank, proc in procs:
        while not (rundir / f'ready{rank}').exists():
            if proc.poll() is not None:
                raise RuntimeError(f'rank {rank} exited with code '
                                   f'{proc.returncode} before the rendezvous')
            if time.monotonic() > deadline:
                raise RuntimeError(f'rank {rank} did not reach the '
                                   f'rendezvous in {timeout:.0f} s')
            time.sleep(0.01)


def run(target: str, args: tuple, devices: Sequence,
        workdir: str = None) -> List[Any]:
    """``target(*args)`` in every rank of a mesh over ``devices`` (one rank
    each, in order); returns the ranks' results in rank order. ``target``
    is ``'module:function'``, importable in a fresh interpreter with this
    process's ``sys.path``; ``args`` and the results are pickled. This
    process runs rank 0. The children write no standard output (rank 0
    prints the run; their errors still reach standard error) and run with
    this process's count of torch threads. The rendezvous lives in a
    temporary directory under ``workdir`` (default: the system's)."""
    plan = mesh_lib.Mesh(tuple(devices))
    rundir = Path(tempfile.mkdtemp(prefix='.mesh-', dir=workdir))
    with open(rundir / 'call.pkl', 'wb') as f:
        pickle.dump((target, args, [str(d) for d in plan.devices]), f)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(sys.path),
               OMP_NUM_THREADS=str(torch.get_num_threads()))
    timeout = mesh_lib.TIMEOUT.total_seconds()
    procs = []
    try:
        for rank in range(1, plan.size):
            procs.append((rank, subprocess.Popen(
                [sys.executable, '-m', __name__, str(rundir), str(rank)],
                env=env, stdout=subprocess.DEVNULL)))
        _wait_ready(procs, rundir, timeout)
        mesh = mesh_lib.join(plan, 0, (rundir / 'rendezvous').as_uri())
        try:
            results = [_resolve(target)(*args)]
        except BaseException as e:
            raise _failure(procs, e) from e
        finally:
            mesh_lib.leave()
        for rank, proc in procs:
            code = proc.wait(timeout=timeout)
            if code != 0:
                raise RuntimeError(f'rank {rank} of {mesh.size} exited with '
                                   f'code {code}')
            with open(rundir / f'result{rank}.pkl', 'rb') as f:
                results.append(pickle.load(f))
        return results
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(rundir, ignore_errors=True)


def _failure(procs, error: BaseException) -> BaseException:
    """The error to raise for rank 0's ``error``: naming any child that
    exited with a non-zero code (the cause a failed collective hides),
    given a second to exit."""
    dead = []
    for rank, proc in procs:
        try:
            code = proc.wait(timeout=1.0)
        except subprocess.TimeoutExpired:
            continue
        if code:
            dead.append(f'rank {rank} exited with code {code}')
    if not dead:
        return error
    return RuntimeError('; '.join(dead) + f' (rank 0: {error!r})')


def _child(rundir: Path, rank: int) -> int:
    with open(rundir / 'call.pkl', 'rb') as f:
        target, args, devices = pickle.load(f)
    fn = _resolve(target)
    (rundir / f'ready{rank}').touch()
    mesh_lib.join(mesh_lib.Mesh(tuple(devices)), rank,
                  (rundir / 'rendezvous').as_uri())
    try:
        result = fn(*args)
    finally:
        mesh_lib.leave()
    with open(rundir / f'result{rank}.pkl.tmp', 'wb') as f:
        pickle.dump(result, f)
    os.replace(rundir / f'result{rank}.pkl.tmp',
               rundir / f'result{rank}.pkl')
    return 0


if __name__ == '__main__':
    try:
        code = _child(Path(sys.argv[1]), int(sys.argv[2]))
    except BaseException:
        traceback.print_exc()
        code = 1
    sys.stderr.flush()
    sys.stdout.flush()
    os._exit(code)
