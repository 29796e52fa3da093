"""The program as ``challenge_tpu_torch.cli.trainer`` builds it at its
defaults: the flags parsed by the CLI's own parser, the density model
(``get_density_model``), the count + total-variation loss with the kernel
penalty (``make_loss_fn``), ``TrainLoop`` in iterator mode (graphed
``TrainStep`` and ``EvalStep``) over two ``DevicePipeline``s of the
density batches. The CLI's file writing and its callbacks are left
out."""

from __future__ import annotations

from h100_bench.entries import Program, check_sizes


def build_fit(cfg: dict, seed: int, device, train_src, test_src) -> Program:
    from challenge_tpu_torch.cli import trainer
    from challenge_tpu_torch.data.pipeline import DevicePipeline, build_banks
    from challenge_tpu_torch.models.registry import get_density_model
    from challenge_tpu_torch.train import TrainLoop
    ns = trainer.build_args().parse_args(list(cfg['argv'])
                                         + ['--seed', str(seed)])
    config = trainer.to_config(ns)
    trainer.refuse_unported(config)
    check_sizes(cfg, config, ns.n_classes, ns.multiplier)
    bundle = get_density_model(config, device=device, seed=config.seed)
    loop = TrainLoop(bundle, seed=config.seed,
                     loss_fn=trainer.make_loss_fn(ns))

    def pipeline(src, training):
        banks = build_banks(*src, n_classes=ns.n_classes, one_hot=True,
                            n_frame=config.n_frame,
                            flat_dtype=config.bank_dtype, device=device)
        return DevicePipeline(banks, config, training, device=device,
                              variant='density', n_classes=ns.n_classes)
    return Program(loop, pipeline(train_src, True), pipeline(test_src, False))
