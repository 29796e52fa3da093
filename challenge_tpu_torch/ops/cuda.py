"""Building and loading the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled with
``nvcc`` for Hopper (``sm_90a``) into ``build/challenge_tpu_torch/`` at the
repository root, at first use, then loaded with ``ctypes``. The library's
file name carries a hash of its source and of the shared headers
(``csrc/*.cuh``), so an edited kernel is rebuilt and a stale one is never
loaded. Nothing here runs at import time: the CPU tests
import every module on machines with no ``nvcc``.

``LAUNCHES`` counts kernel launches by name. Each wrapper adds one where it
launches its kernel and nowhere else, so a run can show which kernels its
main path went through.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'challenge_tpu_torch'
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC']

LAUNCHES: collections.Counter = collections.Counter()
_LIBS: dict = {}


def reset_launch_counts() -> None:
    LAUNCHES.clear()


def _nvcc() -> str:
    home = os.environ.get('CUDA_HOME') or os.environ.get('CUDA_PATH') \
        or '/usr/local/cuda'
    path = Path(home) / 'bin' / 'nvcc'
    return str(path) if path.exists() else 'nvcc'


def _library_path(name: str) -> Path:
    text = (CSRC / f'{name}.cu').read_bytes() + b''.join(
        p.read_bytes() for p in sorted(CSRC.glob('*.cuh')))
    digest = hashlib.sha256(text + ' '.join(NVCC_FLAGS).encode()
                            ).hexdigest()[:16]
    return BUILD_DIR / f'lib{name}-{digest}.so'


def build(names, verbose: bool = False) -> float:
    """Compile every named source that is not built yet, one ``nvcc`` each,
    all started together. Returns the wall seconds; raises with the
    compiler's output if any build fails."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in names:
        out = _library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f'.{os.getpid()}.tmp')
        cmd = [_nvcc(), *NVCC_FLAGS, *(['-Xptxas', '-v'] if verbose else []),
               '-o', str(tmp), str(CSRC / f'{name}.cu')]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((name, out, tmp, proc))
    failed = []
    for name, out, tmp, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f'--- nvcc {name}.cu (exit {proc.returncode})\n{log}')
            continue
        if verbose and log.strip():
            print(f'--- nvcc {name}.cu\n{log}', flush=True)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError('kernel build failed:\n' + '\n'.join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = _LIBS[name] = ctypes.CDLL(str(_library_path(name)))
    return lib
