"""CIFAR-10 CNN generator search.

Port of adanet_tpu/examples/tutorials/cifar10_cnn.py: an adaptive search
over progressively deeper CNNs (`examples.simple_cnn.CNNGenerator`) with
learned, complexity-penalised mixture weights. Loads the CIFAR-10 python
archive from `--data_dir` when given (`research.improve_nas.cifar10`,
evaluated on its test batch), else runs on synthetic CIFAR-shaped data.

Run: python -m adanet_tpu_torch.examples.tutorials.cifar10_cnn [--device cpu]
"""

from __future__ import annotations

import argparse
import tempfile

import numpy as np
import torch

from adanet_tpu_torch.core.estimator import Estimator
from adanet_tpu_torch.core.heads import MultiClassHead
from adanet_tpu_torch.ensemble.strategy import GrowStrategy
from adanet_tpu_torch.ensemble.weighted import ComplexityRegularizedEnsembler
from adanet_tpu_torch.examples.simple_cnn import CNNGenerator


def synthetic_provider(batch_size: int):
    rng = np.random.RandomState(0)
    x = rng.rand(2048, 32, 32, 3).astype(np.float32)
    y = rng.randint(0, 10, size=(2048,)).astype(np.int32)

    def input_fn():
        for start in range(0, 2048 - batch_size + 1, batch_size):
            yield {"image": x[start:start + batch_size]}, y[start:start + batch_size]

    class Provider:
        num_classes = 10

        def get_input_fn(self, partition="train"):
            return input_fn

    return Provider()


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--data_dir", default=None)
    parser.add_argument("--model_dir", default=None)
    parser.add_argument("--max_steps", type=int, default=3000)
    parser.add_argument("--iterations", type=int, default=3)
    parser.add_argument("--batch_size", type=int, default=128)
    parser.add_argument("--channels", type=int, default=64)
    parser.add_argument("--device", default=None, help="the card by default; 'cpu' to run on the CPU")
    args = parser.parse_args(argv)

    if args.data_dir:
        from adanet_tpu_torch.research.improve_nas import cifar10

        provider = cifar10.Provider(args.data_dir, args.batch_size)
    else:
        print("No --data_dir; using synthetic CIFAR-shaped data.")
        provider = synthetic_provider(args.batch_size)

    estimator = Estimator(
        head=MultiClassHead(n_classes=provider.num_classes),
        subnetwork_generator=CNNGenerator(initial_num_blocks=1, channels=args.channels),
        max_iteration_steps=args.max_steps // args.iterations,
        # The mixture weights combine through K1 (use_fused_combine).
        ensemblers=[
            ComplexityRegularizedEnsembler(
                optimizer=lambda params: torch.optim.SGD(params, lr=0.01),
                adanet_lambda=0.01,
                warm_start_mixture_weights=True,
                use_fused_combine=True,
            )
        ],
        ensemble_strategies=[GrowStrategy()],
        max_iterations=args.iterations,
        model_dir=args.model_dir or tempfile.mkdtemp(prefix="cifar10_cnn_"),
        device=args.device,
    )
    estimator.train(provider.get_input_fn("train"), max_steps=args.max_steps)
    metrics = estimator.evaluate(provider.get_input_fn("test" if args.data_dir else "train"))
    print("Eval metrics:", metrics)
    return metrics


if __name__ == "__main__":
    main()
