"""MNIST with the simple_dnn search space.

Port of adanet_tpu/examples/tutorials/mnist_simple_dnn.py. Loads the
standard MNIST idx files from --data_dir when present, else runs on a
synthetic stand-in with MNIST shapes (4096 x 784).

Run: python -m adanet_tpu_torch.examples.tutorials.mnist_simple_dnn [--device cpu]
"""

from __future__ import annotations

import argparse
import gzip
import os
import struct
import tempfile

import numpy as np
import torch

from adanet_tpu_torch.core.estimator import Estimator
from adanet_tpu_torch.core.heads import MultiClassHead
from adanet_tpu_torch.ensemble.weighted import ComplexityRegularizedEnsembler
from adanet_tpu_torch.examples import simple_dnn


def _read_idx(path):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic = struct.unpack(">HBB", f.read(4))
        dims = struct.unpack(">" + "I" * magic[2], f.read(4 * magic[2]))
        return np.frombuffer(f.read(), np.uint8).reshape(dims)


def load_mnist(data_dir):
    candidates = [
        ("train-images-idx3-ubyte", "train-labels-idx1-ubyte"),
        ("train-images-idx3-ubyte.gz", "train-labels-idx1-ubyte.gz"),
    ]
    for images_name, labels_name in candidates:
        images_path = os.path.join(data_dir or "", images_name)
        labels_path = os.path.join(data_dir or "", labels_name)
        if os.path.exists(images_path) and os.path.exists(labels_path):
            x = _read_idx(images_path).astype(np.float32) / 255.0
            y = _read_idx(labels_path).astype(np.int32)
            return x.reshape(len(x), -1), y
    rng = np.random.RandomState(0)
    x = rng.rand(4096, 784).astype(np.float32)
    y = rng.randint(0, 10, size=(4096,)).astype(np.int32)
    print("MNIST files not found; using synthetic stand-in data.")
    return x, y


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--data_dir", default=None)
    parser.add_argument("--model_dir", default=None)
    parser.add_argument("--max_steps", type=int, default=3000)
    parser.add_argument("--iterations", type=int, default=3)
    parser.add_argument("--batch_size", type=int, default=64)
    parser.add_argument("--device", default=None, help="the card by default; 'cpu' to run on the CPU")
    args = parser.parse_args(argv)

    x, y = load_mnist(args.data_dir)
    split = int(0.9 * len(x))

    def input_fn(start=0, end=split):
        def gen():
            n = ((end - start) // args.batch_size) * args.batch_size
            for s in range(start, start + n, args.batch_size):
                yield {"x": x[s:s + args.batch_size]}, y[s:s + args.batch_size]

        return gen

    estimator = Estimator(
        head=MultiClassHead(n_classes=10),
        subnetwork_generator=simple_dnn.Generator(
            optimizer_fn=lambda params: torch.optim.SGD(params, lr=0.05, momentum=0.9),
            layer_size=128,
            initial_num_layers=1,
            dropout=0.1,
        ),
        max_iteration_steps=args.max_steps // args.iterations,
        # The mixture weights combine through K1 (use_fused_combine).
        ensemblers=[
            ComplexityRegularizedEnsembler(
                optimizer=lambda params: torch.optim.SGD(params, lr=0.01), adanet_lambda=0.01,
                use_fused_combine=True,
            )
        ],
        max_iterations=args.iterations,
        model_dir=args.model_dir or tempfile.mkdtemp(prefix="mnist_simple_dnn_"),
        device=args.device,
    )
    estimator.train(input_fn(), max_steps=args.max_steps)
    metrics = estimator.evaluate(input_fn(split, len(x)))
    print("Test metrics:", metrics)
    return metrics


if __name__ == "__main__":
    main()
