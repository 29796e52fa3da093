"""The program as ``challenge_tpu_torch.cli.sj_train`` builds it: the
configuration from the CLI's flags, ``get_model``, slim banks and
``TrainLoop`` in banks mode (the fused step, one CUDA graph a step). The
CLI's file writing (checkpoints, CSV log, TensorBoard) and its callbacks
are left out."""

from __future__ import annotations

from h100_bench.entries import Program, check_sizes


def port_config(cfg: dict, seed: int):
    from challenge_tpu_torch.config import config_from_args
    config = config_from_args(list(cfg['argv']) + ['--seed', str(seed)])
    config.loss = config.loss.upper()
    check_sizes(cfg, config, config.n_classes, config.mse_multiplier)
    return config


def build_fit(cfg: dict, seed: int, device, train_src, test_src) -> Program:
    from challenge_tpu_torch.data.pipeline import build_banks
    from challenge_tpu_torch.models.registry import get_model
    from challenge_tpu_torch.train import TrainLoop
    config = port_config(cfg, seed)
    bundle = get_model(config, device=device, seed=config.seed)

    def banks(src):
        return build_banks(*src, n_classes=config.n_classes, one_hot=True,
                           n_frame=config.n_frame,
                           flat_dtype=config.bank_dtype, device=device)
    loop = TrainLoop(bundle, seed=config.seed, banks=banks(train_src),
                     val_banks=banks(test_src))
    return Program(loop, None, None)

