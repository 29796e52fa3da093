"""Interop with the JAX package's and the reference's formats:
:mod:`keras_h5` (Keras-2 legacy HDF5 weights, both ways), :mod:`aot`
(``torch.export`` serving artifacts) and :mod:`jax_weights` (flax variable
trees to and from ``state_dict``). h5py is imported only where a file is
read or written. JAX's ``refstubs`` and ``keras_compat`` run the absent
TensorFlow reference and have no counterpart."""

from challenge_tpu_torch.interop.aot import export_infer, load_infer
from challenge_tpu_torch.interop.keras_h5 import (
    export_keras_legacy_h5, load_keras_h5_variables, save_keras_h5_variables)

__all__ = ['export_infer', 'load_infer', 'export_keras_legacy_h5',
           'load_keras_h5_variables', 'save_keras_h5_variables']
