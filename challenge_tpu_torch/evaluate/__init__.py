from challenge_tpu_torch.evaluate.events import (
    get_er, get_start_end_frame, output_to_metric)
from challenge_tpu_torch.evaluate.infer import (
    clip_scores, evaluate, frame_signal, overlap_and_add, spec_to_scores)

__all__ = ['get_er', 'get_start_end_frame', 'output_to_metric',
           'clip_scores', 'evaluate', 'frame_signal', 'overlap_and_add',
           'spec_to_scores']
