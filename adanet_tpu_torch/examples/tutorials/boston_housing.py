"""AutoEnsemble on Boston-housing-style regression.

Port of adanet_tpu/examples/tutorials/boston_housing.py: an
`AutoEnsembleEstimator` over a linear model and a two-layer DNN under a
`RegressionHead`. Pass --data_npz pointing at an .npz with arrays `x` and
`y`, or run on a synthetic stand-in with the same shape (506 x 13).

Run: python -m adanet_tpu_torch.examples.tutorials.boston_housing [--device cpu]
"""

from __future__ import annotations

import argparse
import tempfile

import numpy as np
import torch
from torch import nn

from adanet_tpu_torch.autoensemble import AutoEnsembleEstimator, AutoEnsembleSubestimator
from adanet_tpu_torch.core.heads import RegressionHead
from adanet_tpu_torch.ensemble.weighted import ComplexityRegularizedEnsembler

NUM_FEATURES = 13


class Linear(nn.Module):
    def __init__(self, in_features: int = NUM_FEATURES):
        super().__init__()
        self.dense = nn.Linear(in_features, 1)

    def forward(self, features, training: bool = False):
        return self.dense(features["x"].float())


class DNN(nn.Module):
    def __init__(self, in_features: int = NUM_FEATURES, hidden: int = 64):
        super().__init__()
        self.dense_0 = nn.Linear(in_features, hidden)
        self.dense_1 = nn.Linear(hidden, hidden)
        self.logits = nn.Linear(hidden, 1)

    def forward(self, features, training: bool = False):
        x = torch.relu(self.dense_0(features["x"].float()))
        x = torch.relu(self.dense_1(x))
        return self.logits(x)


def load_data(data_npz: str | None):
    if data_npz:
        data = np.load(data_npz)
        x, y = data["x"].astype(np.float32), data["y"].astype(np.float32)
    else:
        rng = np.random.RandomState(7)
        x = rng.randn(506, 13).astype(np.float32)
        w = rng.randn(13).astype(np.float32)
        y = x @ w + 0.5 * rng.randn(506).astype(np.float32)
    y = y.reshape(-1, 1)
    x = (x - x.mean(0)) / (x.std(0) + 1e-8)
    split = int(0.8 * len(x))
    return (x[:split], y[:split]), (x[split:], y[split:])


def make_input_fn(x, y, batch_size=32):
    def input_fn():
        n = (len(x) // batch_size) * batch_size
        for start in range(0, n, batch_size):
            yield {"x": x[start:start + batch_size]}, y[start:start + batch_size]

    return input_fn


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--data_npz", default=None)
    parser.add_argument("--model_dir", default=None)
    parser.add_argument("--max_steps", type=int, default=600)
    parser.add_argument("--iterations", type=int, default=3)
    parser.add_argument("--device", default=None, help="the card by default; 'cpu' to run on the CPU")
    args = parser.parse_args(argv)

    (train_x, train_y), (test_x, test_y) = load_data(args.data_npz)
    estimator = AutoEnsembleEstimator(
        head=RegressionHead(),
        candidate_pool={
            "linear": AutoEnsembleSubestimator(
                Linear(train_x.shape[1]), lambda params: torch.optim.SGD(params, lr=0.01, momentum=0.9)
            ),
            "dnn": AutoEnsembleSubestimator(
                DNN(train_x.shape[1]), lambda params: torch.optim.Adam(params, lr=1e-3, fused=True)
            ),
        },
        max_iteration_steps=args.max_steps // args.iterations,
        # The mixture weights combine through K1 (use_fused_combine).
        ensemblers=[
            ComplexityRegularizedEnsembler(
                optimizer=lambda params: torch.optim.SGD(params, lr=0.01), use_fused_combine=True
            )
        ],
        max_iterations=args.iterations,
        model_dir=args.model_dir or tempfile.mkdtemp(prefix="boston_autoensemble_"),
        device=args.device,
    )
    estimator.train(make_input_fn(train_x, train_y), max_steps=args.max_steps)
    metrics = estimator.evaluate(make_input_fn(test_x, test_y))
    print("Test metrics:", metrics)
    return metrics


if __name__ == "__main__":
    main()
