"""Event extraction and the challenge error rate (host-side numpy).

The reference implements these with dynamic-shape TF ops
(metrics.py:93-214); event lists are inherently variable-length, so the
TPU-native split is: everything up to the thresholded frame grid runs jitted
on device (see ``infer.py``), and the tiny variable-length tail — event
pair-up and greedy matching — runs here in numpy, exactly matching the
reference's semantics (including truncating casts and the odd-count fix).
"""

from __future__ import annotations

import numpy as np


def get_start_end_frame(data):
    """0/1 frame grid [T, 3] -> per-class event arrays [n_events, 2] of
    [start_frame, end_frame] with end = last frame of the run
    (reference: metrics.py:109-133)."""
    data = np.asarray(data)
    t = len(data)
    prev = np.concatenate([np.zeros((1, data.shape[1])), data[:-1]], axis=0)
    diff = np.argwhere(prev != data)          # rows (t, class), t-major order
    out = []
    for c in range(data.shape[1]):
        idx = diff[diff[:, 1] == c][:, 0]
        if len(idx) % 2 != 0:                 # run still open at the end
            idx = np.concatenate([idx, [t]])
        pairs = idx.reshape(-1, 2)
        out.append(np.stack([pairs[:, 0], pairs[:, 1] - 1], axis=1)
                   .astype(np.int64))
    return tuple(out)


def get_start_end_time(data, sr: int = 16000, hop: int = 256):
    """Events in (rounded) seconds, deduplicated
    (reference: metrics.py:99-107)."""
    out = []
    for cls in get_start_end_frame(data):
        secs = np.round(cls * hop / sr).astype(np.int32)
        _, first = np.unique(secs, return_index=True, axis=0)
        out.append(secs[np.sort(first)])
    return tuple(out)


def get_second_answer(data, sr: int = 16000, hop: int = 256):
    """Per-second majority vote variant (reference: metrics.py:135-146)."""
    data = np.asarray(data, np.float32)
    data_second = np.asarray([hop * i // sr for i in range(len(data))])
    n_sec = int(np.max(data_second))
    second_true = np.zeros([n_sec, data.shape[1]])
    for i in range(n_sec):
        sel = data_second == i
        second_true[i] = np.mean(data[sel], axis=0) > 0.5
    return tuple(c.astype(np.int32)
                 for c in get_start_end_frame(second_true))


def extract_middle(y_pred):
    """Per-event midpoints of a batched 0/1 grid [batch, time, cls] as rows
    (batch, mid_frame, cls) (reference: metrics.py:160-173)."""
    y_pred = np.asarray(y_pred)
    rows = []
    for b in range(y_pred.shape[0]):
        classes = get_start_end_frame(y_pred[b])
        for c, events in enumerate(classes):
            for s, e in events:
                rows.append([b, (s + e) // 2, c])
    rows.sort(key=lambda r: (r[0], r[2], r[1]))
    if not rows:
        return np.zeros((0, 3), np.int64)
    return np.asarray(rows, np.int64)


def output_to_metric(hop: int = 256, sr: int = 16000):
    """Events -> [class, midpoint_seconds] rows (reference:
    metrics.py:196-214; the int cast truncates like tf.cast)."""
    def _output_to_metric(cls0, cls1, cls2):
        rows = []
        for c, cls in enumerate((cls0, cls1, cls2)):
            for item in np.asarray(cls):
                rows.append([c, int(((item[0] + item[1]) / 2) * hop / sr)])
        if not rows:
            return np.zeros((0, 2), np.int32)
        return np.asarray(rows, np.int32)
    return _output_to_metric


def get_er(gt, predict):
    """Greedy event matching (reference: metrics.py:176-193): each GT event
    [class, start_s, end_s] consumes the first unused prediction
    [class, mid_s] with the same class and midpoint inside the window;
    ER = (|gt| + |pred| - 2 * matches) / |gt|."""
    predict = np.asarray(predict)
    gt = np.asarray(gt)
    if len(predict):
        predict = predict[np.argsort(predict[:, 1], kind='stable')]
    gt = gt[np.argsort(gt[:, 1], kind='stable')]
    n = len(predict) + len(gt)
    answer = 0
    remaining = list(map(tuple, predict))
    for gt_item in gt:
        for i, pred_item in enumerate(remaining):
            if gt_item[1] <= pred_item[1] <= gt_item[2] and \
                    gt_item[0] == pred_item[0]:
                answer += 2
                del remaining[i]
                break
    return (n - answer) / len(gt)


def second2frame(seconds, frame_num: int, resolution: float):
    """Rasterize [class, start_s, end_s] events onto a frame grid
    (reference: eval.py:30-38)."""
    frames = np.zeros([frame_num, 3], dtype=np.float32)
    for second in seconds:
        class_num = int(second[0])
        start = int(np.round(second[1] * resolution))
        end = int(np.round(second[2] * resolution))
        frames[start:end, class_num] += 1
    return frames


class ChallengeMetric:
    """API-parity wrapper (reference: metrics.py:93-157 Challenge_Metric)."""

    def __init__(self, sr: int = 16000, hop: int = 256) -> None:
        self.sr = sr
        self.hop = hop

    def get_start_end_frame(self, data):
        return get_start_end_frame(data)

    def get_start_end_time(self, data):
        return get_start_end_time(data, self.sr, self.hop)

    def get_second_answer(self, data):
        return get_second_answer(data, self.sr, self.hop)

    def reset_state(self):
        pass


Challenge_Metric = ChallengeMetric   # reference spelling (metrics.py:93)
