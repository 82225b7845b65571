"""improve_nas trainer CLI.

Port of research/improve_nas/trainer/trainer.py: the same flags and
defaults, through argparse, plus `--device` (the card unless "cpu"). It
searches NASNet-A ensembles with AdaNet (boosting iterations, adanet
lambda/beta, knowledge distillation, learned mixture weights, generator
choice), trains, evaluates, and prints the final metrics as one JSON
line. Only `--dataset=fake` runs: the CIFAR providers wait until their
files are in the repository. `--model_dir` defaults to a new temporary
directory. Run again over the same `--model_dir`, it resumes the search
where the checkpoint stands; on SIGTERM it checkpoints at the next step,
evaluates the current best ensemble and exits 0, as the Estimator does.

Example (fake data):
    python -m adanet_tpu_torch.research.improve_nas.trainer \\
        --dataset=fake --num_cells=3 --num_conv_filters=4 \\
        --boosting_iterations=2 --train_steps=8 --batch_size=16 --device=cpu
"""

from __future__ import annotations

import argparse
import json
import logging
import sys

import torch

from adanet_tpu_torch.core.estimator import Estimator
from adanet_tpu_torch.core.heads import MultiClassHead
from adanet_tpu_torch.ensemble.strategy import GrowStrategy
from adanet_tpu_torch.ensemble.weighted import ComplexityRegularizedEnsembler, MixtureWeightType
from adanet_tpu_torch.research.improve_nas import fake_data, improve_nas, optimizer

_LOG = logging.getLogger("adanet_tpu_torch")


def _bool(text: str) -> bool:
    value = text.lower()
    if value in ("1", "true", "t", "yes", "y"):
        return True
    if value in ("0", "false", "f", "no", "n"):
        return False
    raise argparse.ArgumentTypeError("not a boolean: %r" % text)


def _add_bool(parser, name: str, default: bool, help_text: str) -> None:
    """absl's boolean flag: `--name`, `--name=false` and `--noname`."""
    parser.add_argument("--" + name, type=_bool, nargs="?", const=True, default=default, help=help_text)
    parser.add_argument("--no" + name, dest=name, action="store_false", help=argparse.SUPPRESS)


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--model_dir", default="", help="Model directory (a new temporary one when empty).")
    parser.add_argument("--dataset", default="fake", help="Dataset: cifar10, cifar100, or fake.")
    parser.add_argument("--data_dir", default="", help="Directory with the CIFAR archives.")
    parser.add_argument("--batch_size", type=int, default=32, help="Per-step batch size.")
    parser.add_argument("--train_steps", type=int, default=10000, help="Total training steps.")
    parser.add_argument("--boosting_iterations", type=int, default=10, help="AdaNet boosting iterations.")
    parser.add_argument("--adanet_lambda", type=float, default=0.0, help="Complexity penalty lambda.")
    parser.add_argument("--adanet_beta", type=float, default=0.0, help="Uniform L1 penalty beta.")
    _add_bool(parser, "learn_mixture_weights", False, "Train mixture weights.")
    parser.add_argument("--knowledge_distillation", default="none",
                        help="Distillation: none, adaptive, or born_again.")
    parser.add_argument("--generator", default="simple", help="Search space: simple or dynamic.")
    parser.add_argument("--num_cells", type=int, default=18, help="NASNet cells (multiple of 3).")
    parser.add_argument("--num_conv_filters", type=int, default=32, help="NASNet base filters.")
    parser.add_argument("--initial_learning_rate", type=float, default=0.025, help="Initial LR.")
    parser.add_argument("--optimizer", default="momentum", help="Optimizer: sgd, momentum, rmsprop, adam.")
    parser.add_argument("--learning_rate_schedule", default="cosine", help="Schedule: constant or cosine.")
    _add_bool(parser, "force_grow", True, "Force ensemble growth.")
    parser.add_argument("--seed", type=int, default=42, help="Random seed.")
    parser.add_argument("--device", default="cuda", help="Where the search runs: cuda or cpu.")
    return parser.parse_args(argv)


def _provider(flags):
    if flags.dataset == "fake":
        return fake_data.FakeImageProvider(
            num_examples=max(64, flags.batch_size * 4),
            batch_size=flags.batch_size,
            seed=flags.seed,
        )
    if flags.dataset in ("cifar10", "cifar100"):
        raise ValueError("dataset %r: the CIFAR providers are not ported yet; use --dataset=fake" % flags.dataset)
    raise ValueError("Unknown dataset %r" % flags.dataset)


def main(argv=None) -> int:
    flags = parse_args(argv)
    provider = _provider(flags)
    max_iteration_steps = max(1, flags.train_steps // flags.boosting_iterations)

    hparams = improve_nas.Hparams(
        num_cells=flags.num_cells,
        num_conv_filters=flags.num_conv_filters,
        knowledge_distillation=improve_nas.KnowledgeDistillation(flags.knowledge_distillation),
        initial_learning_rate=flags.initial_learning_rate,
        total_training_steps=flags.train_steps,
    )
    optimizer_fn = optimizer.fn_with_name(
        flags.optimizer,
        learning_rate_schedule=flags.learning_rate_schedule,
        cosine_decay_steps=max_iteration_steps,
    )
    generator_cls = improve_nas.DynamicGenerator if flags.generator == "dynamic" else improve_nas.Generator
    generator = generator_cls(
        optimizer_fn=optimizer_fn,
        hparams=hparams,
        seed=flags.seed,
        num_classes=provider.num_classes,
    )

    mixture_optimizer = None
    if flags.learn_mixture_weights:
        def mixture_optimizer(params):
            return torch.optim.SGD(params, lr=0.01)

    estimator = Estimator(
        head=MultiClassHead(provider.num_classes),
        subnetwork_generator=generator,
        max_iteration_steps=max_iteration_steps,
        ensemblers=[
            ComplexityRegularizedEnsembler(
                optimizer=mixture_optimizer,
                mixture_weight_type=MixtureWeightType.SCALAR,
                adanet_lambda=flags.adanet_lambda,
                adanet_beta=flags.adanet_beta,
            )
        ],
        ensemble_strategies=[GrowStrategy()],
        max_iterations=flags.boosting_iterations,
        force_grow=flags.force_grow,
        model_dir=flags.model_dir or None,
        random_seed=flags.seed,
        device=flags.device,
    )

    estimator.train(provider.get_input_fn("train"), max_steps=flags.train_steps)
    metrics = estimator.evaluate(provider.get_input_fn("test"))
    _LOG.info("Final metrics: %s", metrics)
    print(json.dumps({k: v for k, v in metrics.items() if isinstance(v, (int, float, str))}))
    return 0


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    sys.exit(main())
