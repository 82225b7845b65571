"""ImageNet AutoEnsemble trainer CLI: ResNet + EfficientNet candidates.

Port of research/imagenet_autoensemble/trainer.py: the same flags and
defaults, through argparse, plus `--device` (the card unless "cpu"). It
wires ResNet-50 (width 64) and EfficientNet-B0 candidates through
`AutoEnsembleEstimator`, every ensemble combine through K1
(`ops/ensemble_kernels.py`, `use_fused_combine`), trains,
evaluates, and prints the final metrics as one JSON line; `main(argv)`
returns the exit code. `--dataset=fake` is `imagenet_data.
SyntheticProvider` (8 classes), `--dataset=imagenet` an extracted
ImageNet tree (decoded with PIL). Inputs under 100 pixels take the
families' small-input stems. `--model_dir` defaults to a new temporary
directory.

The candidates' optimizers are optax's recipes, run by
`research.improve_nas.optimizer.Chain`: ResNet `optax.sgd(lr,
momentum=0.9)`, EfficientNet `optax.rmsprop(lr, decay=0.9, eps=1e-3,
initial_scale=1.0, momentum=0.9)` (the published epsilon and a warm-
started accumulator: with nu at 0 and a tiny eps the first updates are
about 1e4 times the gradient), each under `clip_by_global_norm` when
`--clip_gradients` > 0. `--placement=round_robin` trains through
`distributed.RoundRobinStrategy` (each candidate in its group, the
mixture weights in the ensemble group; on the CPU with `--device=cpu`).

Example (synthetic, small candidates):
    python -m adanet_tpu_torch.research.imagenet_autoensemble.trainer \\
        --dataset=fake --image_size=32 --resnet_depth=18 --resnet_width=8 \\
        --boosting_iterations=1 --train_steps=10 --batch_size=16 --device=cpu
"""

from __future__ import annotations

import argparse
import json
import logging
import sys

from adanet_tpu_torch._device import resolve_device
from adanet_tpu_torch.autoensemble import AutoEnsembleEstimator, AutoEnsembleSubestimator
from adanet_tpu_torch.core.heads import MultiClassHead
from adanet_tpu_torch.distributed.placement import RoundRobinStrategy
from adanet_tpu_torch.ensemble.strategy import GrowStrategy
from adanet_tpu_torch.ensemble.weighted import ComplexityRegularizedEnsembler, MixtureWeightType
from adanet_tpu_torch.models.efficientnet import EfficientNet
from adanet_tpu_torch.models.resnet import ResNet
from adanet_tpu_torch.research.imagenet_autoensemble import imagenet_data
from adanet_tpu_torch.research.improve_nas import optimizer
from adanet_tpu_torch.research.improve_nas.trainer import _add_bool

_LOG = logging.getLogger("adanet_tpu_torch")


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--model_dir", default="", help="Model directory (a new temporary one when empty).")
    parser.add_argument("--dataset", default="fake", help="Dataset: imagenet or fake.")
    parser.add_argument("--data_dir", default="", help="Extracted ImageNet root (train/<class>/*.JPEG).")
    parser.add_argument("--image_size", type=int, default=224, help="Input resolution.")
    parser.add_argument("--batch_size", type=int, default=64, help="Per-step global batch size.")
    parser.add_argument("--train_steps", type=int, default=250000, help="Total training steps.")
    parser.add_argument("--boosting_iterations", type=int, default=3, help="AdaNet iterations.")
    parser.add_argument("--candidates", default="resnet50,efficientnet_b0",
                        help="Comma list from: resnet50, efficientnet_b0.")
    parser.add_argument("--resnet_depth", type=int, default=50, help="ResNet depth (18/34/50/101).")
    parser.add_argument("--resnet_width", type=int, default=64, help="ResNet base width.")
    parser.add_argument("--efficientnet_variant", default="b0", help="EfficientNet variant.")
    parser.add_argument("--placement", default="replication", help="Placement: replication or round_robin.")
    parser.add_argument("--adanet_lambda", type=float, default=0.0, help="Complexity penalty lambda.")
    _add_bool(parser, "learn_mixture_weights", False, "Train mixture weights.")
    parser.add_argument("--resnet_lr", type=float, default=0.1,
                        help="ResNet SGD learning rate (per-256 batch; scale linearly).")
    parser.add_argument("--efficientnet_lr", type=float, default=0.016,
                        help="EfficientNet RMSProp learning rate (per-256 batch; scale linearly).")
    parser.add_argument("--clip_gradients", type=float, default=5.0,
                        help="Global-norm gradient clip for every candidate (0 disables).")
    parser.add_argument("--seed", type=int, default=42, help="Random seed.")
    parser.add_argument("--device", default="cuda", help="Where the search runs: cuda or cpu.")
    return parser.parse_args(argv)


def _provider(flags):
    if flags.dataset == "fake":
        return imagenet_data.SyntheticProvider(
            num_classes=8,
            num_examples=max(128, flags.batch_size * 4),
            batch_size=flags.batch_size,
            image_size=flags.image_size,
            seed=flags.seed,
        )
    if flags.dataset == "imagenet":
        return imagenet_data.Provider(flags.data_dir, batch_size=flags.batch_size, image_size=flags.image_size,
                                      seed=flags.seed)
    raise ValueError("Unknown dataset %r" % flags.dataset)


def _optimizer(rule: optimizer.Rule, clip_gradients: float):
    """A factory `params -> Chain`: `rule` under `clip_by_global_norm(
    clip_gradients)` when that is positive."""
    return lambda params: optimizer.Chain(params, rule, clip_norm=max(0.0, clip_gradients))


def candidate_pool(flags, num_classes: int, image_size: int):
    """The ResNet + EfficientNet candidate pool, sized to the input
    resolution: inputs under 100 pixels take the small-input stems."""
    small = image_size < 100
    pool = {}
    for name in [c.strip() for c in flags.candidates.split(",") if c]:
        if name == "resnet50":
            pool["resnet%d" % flags.resnet_depth] = AutoEnsembleSubestimator(
                ResNet(logits_dimension=num_classes, depth=flags.resnet_depth, width=flags.resnet_width,
                       small_inputs=small),
                optimizer=_optimizer(optimizer.Rule("momentum", optimizer.constant_schedule(flags.resnet_lr)),
                                     flags.clip_gradients),
            )
        elif name == "efficientnet_b0":
            pool["efficientnet_%s" % flags.efficientnet_variant] = AutoEnsembleSubestimator(
                EfficientNet(logits_dimension=num_classes, variant=flags.efficientnet_variant, small_inputs=small),
                # The published epsilon (1e-3, not optax's 1e-8) and a
                # warm-started accumulator.
                optimizer=_optimizer(optimizer.rmsprop(flags.efficientnet_lr, eps=1e-3,
                                                       initial_scale=1.0, momentum=0.9), flags.clip_gradients),
            )
        else:
            raise ValueError("Unknown candidate %r" % name)
    if not pool:
        raise ValueError("empty --candidates")
    return pool


def build_estimator(flags, provider, model_dir: str):
    if flags.placement not in ("replication", "round_robin"):
        raise ValueError("Unknown placement %r" % flags.placement)
    placement = None
    if flags.placement == "round_robin":
        device = resolve_device(flags.device)
        placement = RoundRobinStrategy([device] if device.type == "cpu" else None)

    def sgd(params):
        return optimizer.Chain(params, optimizer.Rule("sgd", optimizer.constant_schedule(0.01)))

    return AutoEnsembleEstimator(
        head=MultiClassHead(provider.num_classes),
        candidate_pool=candidate_pool(flags, provider.num_classes, flags.image_size),
        max_iteration_steps=max(1, flags.train_steps // flags.boosting_iterations),
        ensemblers=[
            ComplexityRegularizedEnsembler(
                optimizer=sgd if flags.learn_mixture_weights else None,
                mixture_weight_type=MixtureWeightType.SCALAR,
                adanet_lambda=flags.adanet_lambda,
                use_fused_combine=True,
            )
        ],
        ensemble_strategies=[GrowStrategy()],
        max_iterations=flags.boosting_iterations,
        model_dir=model_dir or None,
        random_seed=flags.seed,
        device=flags.device,
        placement_strategy=placement,
    )


def main(argv=None) -> int:
    flags = parse_args(argv)
    provider = _provider(flags)
    estimator = build_estimator(flags, provider, flags.model_dir)
    estimator.train(provider.get_input_fn("train"), max_steps=flags.train_steps)
    metrics = estimator.evaluate(provider.get_input_fn("test"))
    _LOG.info("Final metrics: %s", metrics)
    print(json.dumps({k: v for k, v in metrics.items() if isinstance(v, (int, float, str))}))
    return 0


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    sys.exit(main())
