"""Host I/O: pickled spec sets and .npy label arrays (counterpart:
``challenge_tpu/utils/io.py``; reference: utils.py:88-94). A copy, so the
port imports nothing of the JAX package."""

from __future__ import annotations

import pickle

import numpy as np


def load_data(path: str):
    """Load a pickled list of spectrograms or an .npy label array. Pickles
    run code when loaded: read only spec sets this project's users wrote."""
    if path.endswith('.pickle'):
        with open(path, 'rb') as f:
            return pickle.load(f)
    if path.endswith('.npy'):
        return np.load(path)
    raise ValueError(f'invalid file format: {path!r} (expected .pickle or '
                     '.npy)')


def list_to_generator(dataset):
    """A list, or a tuple of parallel lists, -> a generator factory
    (reference: utils.py:77-85)."""
    def _gen():
        if isinstance(dataset, tuple):
            yield from zip(*dataset)
        else:
            yield from dataset
    return _gen
