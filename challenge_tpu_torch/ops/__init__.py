"""Numeric ops: WAV ingest and STFT, the mel projection, complex-spectrogram
transforms, normalization and augmentation, as functions of tensors (with
an explicit ``torch.Generator`` for the random ones), and the synthesis
kernels (:mod:`synth`, :mod:`cuda`)."""

from challenge_tpu_torch.ops.augment import (
    batch_mask, batch_random_merge_aug, batch_specaugment, mask,
    random_merge_aug, random_shift, specaugment, stft_filter)
from challenge_tpu_torch.ops.complexspec import (
    complex_to_magphase, log_magphase, magphase_to_complex,
    minmax_norm_magphase, phase_vocoder)
from challenge_tpu_torch.ops.dsp import (
    load_wav, load_wav_device, read_wav, resample_matrix, resample_waveform,
    rms_normalize, stft, stft_magnitude, wav_to_spec)
from challenge_tpu_torch.ops.mel import (
    linear_to_mel_weight_matrix, magphase_to_mel, mel_filterbank)
from challenge_tpu_torch.ops.norms import (
    EPSILON, LOG_EPSILON, log_on_mel, minmax, minmax_log_on_mel, safe_div)

__all__ = ['batch_mask', 'batch_random_merge_aug', 'batch_specaugment',
           'mask', 'random_merge_aug', 'random_shift', 'specaugment',
           'stft_filter', 'complex_to_magphase', 'log_magphase',
           'magphase_to_complex', 'minmax_norm_magphase', 'phase_vocoder',
           'load_wav', 'load_wav_device', 'read_wav', 'resample_matrix',
           'resample_waveform', 'rms_normalize', 'stft', 'stft_magnitude',
           'wav_to_spec', 'linear_to_mel_weight_matrix', 'magphase_to_mel',
           'mel_filterbank', 'EPSILON', 'LOG_EPSILON', 'log_on_mel', 'minmax',
           'minmax_log_on_mel', 'safe_div']
