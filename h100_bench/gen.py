"""The benchmark's inputs, made from ``--seed``: the spectrogram sources of
the fit cells and the weights of every cell. The program and the reference
are handed the same.

What the traffic files and configuration files set is read here; nothing
belongs to one cell.
"""

from __future__ import annotations

import numpy as np
import torch


def rng_seed(seed: int, *stream: int) -> np.random.SeedSequence:
    """The numpy seed of ``stream`` under the run's seed (any whole number;
    a negative one is taken modulo 2**64)."""
    return np.random.SeedSequence([seed % (1 << 64), *stream])


def sources(seed: int, n_bg: int, bg_len, n_voice: int, voice_len,
            n_noise: int, noise_len):
    """Random [257, T, 4] float32 complex spectrograms (re0, re1, im0, im1)
    and 30-class voice labels, in bulk from one numpy generator: ``n_bg``
    backgrounds (scale 1), ``n_voice`` voices (0.5), ``n_noise`` noises
    (0.3). A length is an int or an inclusive [lo, hi] range."""
    rng = np.random.default_rng(seed)

    def lengths(n, spec):
        if isinstance(spec, int):
            return [spec] * n
        return rng.integers(spec[0], spec[1] + 1, n).tolist()

    def specs(n, spec, scale):
        ls = lengths(n, spec)
        block = rng.standard_normal((257, sum(ls), 4), dtype=np.float32)
        block *= scale
        ends = np.cumsum(ls)
        return [block[:, e - t:e] for t, e in zip(ls, ends)]

    return (specs(n_bg, bg_len, 1.0), specs(n_voice, voice_len, 0.5),
            rng.integers(0, 30, n_voice), specs(n_noise, noise_len, 0.3))


def fit_sources(seed: int, traffic: dict):
    """(training sources, validation sources) of a fit mix. Validation
    takes the training noises, as the trainers' ``make_banks`` does."""
    train = sources(rng_seed(seed, 0), *traffic['train_sources'])
    test = sources(rng_seed(seed, 1), *traffic['test_sources'])
    return train, test[:3] + (train[3],)


def draw_weights(module: torch.nn.Module, seed: int, device) -> dict:
    """A state dict for ``module``'s names and shapes, drawn on ``device``
    from ``seed`` in one normal draw: each kernel (rank >= 2) scaled by
    1 / sqrt(fan in), biases by 0.01, BN scales 1 + 0.1 z and shifts 0.1 z,
    running means 0.1 z and variances 1 + 0.1 |z|; integer buffers 0."""
    shapes = {k: v.shape for k, v in module.state_dict().items()}
    total = sum(int(np.prod(s)) for s in shapes.values())
    gen = torch.Generator(device=device)
    gen.manual_seed(int(rng_seed(seed, 3).generate_state(1, np.uint64)[0]))
    z = torch.randn(total, generator=gen, device=device)
    out, i = {}, 0
    for k, s in shapes.items():
        n = int(np.prod(s))
        v = z[i:i + n].reshape(s)
        i += n
        leaf = k.rsplit('.', 1)[-1]
        if len(s) >= 2:
            v = v / float(np.sqrt(np.prod(s[1:])))
        elif leaf == 'running_var':
            v = 1.0 + 0.1 * v.abs()
        elif leaf == 'weight':               # a BatchNorm's scale
            v = 1.0 + 0.1 * v
        elif leaf == 'bias' and '.bns.' not in k and '_bn.' not in k \
                and '.bn.' not in k:
            v = 0.01 * v
        else:                                # BN shift, running mean
            v = 0.1 * v
        out[k] = v.contiguous()
    return out
