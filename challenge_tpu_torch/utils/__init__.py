from challenge_tpu_torch.utils.io import list_to_generator, load_data
from challenge_tpu_torch.utils.predict import predict
from challenge_tpu_torch.utils.windows import seq_to_windows, windows_to_seq

__all__ = ['list_to_generator', 'load_data', 'predict', 'seq_to_windows',
           'windows_to_seq']
