from challenge_tpu_torch.data.labels import (
    label_downsample, mono_chan, multiply_label, preprocess_labels,
    speech_enhancement_preprocess, stereo_mono, to_density_labels,
    to_frame_labels)
from challenge_tpu_torch.data.mixture import (
    Banks, Draws, draw, merge_complex_specs, sample_batch, synthesize)
from challenge_tpu_torch.data.pipeline import (
    LABEL_DOWNSAMPLE_MODELS, DevicePipeline, FeatureFn, build_banks,
    make_feature_fn, make_pipeline)
from challenge_tpu_torch.data.specset import SpecBank, build_bank, remap_labels
from challenge_tpu_torch.data.streaming import (
    StreamingBanks, build_streaming_banks)

__all__ = ['label_downsample', 'mono_chan', 'multiply_label',
           'preprocess_labels', 'speech_enhancement_preprocess',
           'stereo_mono', 'to_density_labels', 'to_frame_labels', 'Banks',
           'Draws', 'draw', 'merge_complex_specs', 'sample_batch',
           'synthesize', 'LABEL_DOWNSAMPLE_MODELS', 'DevicePipeline',
           'FeatureFn', 'build_banks', 'make_feature_fn', 'make_pipeline',
           'SpecBank', 'build_bank', 'remap_labels', 'StreamingBanks',
           'build_streaming_banks']
