from challenge_tpu_torch.evaluate.events import (
    Challenge_Metric, ChallengeMetric, extract_middle, get_er,
    get_second_answer, get_start_end_frame, get_start_end_time,
    output_to_metric, second2frame)
from challenge_tpu_torch.evaluate.infer import (
    clip_scores, evaluate, frame_signal, make_infer_fn, overlap_and_add,
    spec_to_scores)

__all__ = ['Challenge_Metric', 'ChallengeMetric', 'extract_middle', 'get_er',
           'get_second_answer', 'get_start_end_frame', 'get_start_end_time',
           'output_to_metric', 'second2frame', 'clip_scores', 'evaluate',
           'frame_signal', 'make_infer_fn', 'overlap_and_add',
           'spec_to_scores']
