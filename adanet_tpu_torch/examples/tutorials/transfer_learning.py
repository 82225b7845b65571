"""Transfer learning: ensemble a frozen pretrained module with AdaNet.

Port of adanet_tpu/examples/tutorials/transfer_learning.py (the analogue
of the reference's TF-Hub customization tutorial). "Pretrained" means
trained in-process:

1. PRETRAIN a small conv encoder + classifier on a SOURCE task (clean,
   shift-free digit renderings), in a plain torch loop (Adam 1e-3,
   softmax cross-entropy, parameters drawn from a seeded
   `torch.Generator`).
2. TRANSFER to the harder TARGET task (noisy, shifted digits): an
   `AutoEnsembleEstimator` searches over
     - the pretrained module, FROZEN (`prediction_only=True` +
       `initial_variables=` carrying its trained `state_dict`),
     - a fine-tuned copy of the same module (trainable, same init), and
     - a fresh linear model,
   and learns mixture weights over whichever members help (through K1,
   `use_fused_combine`).

The frozen candidate's weights never move (AdaNet only learns how much to
trust it), yet it lifts the ensemble far above the from-scratch linear
baseline.

Run: python -m adanet_tpu_torch.examples.tutorials.transfer_learning [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import torch
import torch.nn.functional as F
from torch import nn

from adanet_tpu_torch._device import resolve_device
from adanet_tpu_torch.autoensemble import AutoEnsembleEstimator, AutoEnsembleSubestimator
from adanet_tpu_torch.core.heads import MultiClassHead
from adanet_tpu_torch.ensemble.weighted import ComplexityRegularizedEnsembler, full_f32_matmul
from adanet_tpu_torch.examples.simple_dnn import lecun_normal_
from adanet_tpu_torch.examples.synthetic_digits import IMAGE_SIZE, make_dataset


class ConvEncoder(nn.Module):
    """The 'hub module': conv features + linear classifier, on NHWC
    images (3x3 SAME convolutions, a 2x2 average pool, a global mean)."""

    def __init__(self, in_channels: int = 1, channels: int = 16, n_classes: int = 10):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, channels, 3, padding=1)
        self.conv2 = nn.Conv2d(channels, channels * 2, 3, padding=1)
        self.classifier = nn.Linear(channels * 2, n_classes)

    def forward(self, features, training: bool = False):
        x = features["image"] if isinstance(features, dict) else features
        x = x.float().permute(0, 3, 1, 2)
        x = torch.relu(self.conv1(x))
        x = F.avg_pool2d(x, 2, 2)
        x = torch.relu(self.conv2(x))
        return self.classifier(x.mean(dim=(2, 3)))


class LinearModel(nn.Module):
    def __init__(self, in_features: int = IMAGE_SIZE * IMAGE_SIZE, n_classes: int = 10):
        super().__init__()
        self.dense = nn.Linear(in_features, n_classes)

    def forward(self, features, training: bool = False):
        x = features["image"] if isinstance(features, dict) else features
        return self.dense(x.float().reshape(x.shape[0], -1))


def pretrain(images, labels, steps: int, batch_size: int = 128, device=None, seed: int = 0):
    """The plain torch loop standing in for 'download from the hub', in
    full f32 (TF32 off, as in the search's steps). Returns (the trained
    `state_dict` on the CPU, the last loss)."""
    device = resolve_device(device)
    module = ConvEncoder()
    generator = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for layer in (module.conv1, module.conv2, module.classifier):
            lecun_normal_(layer.weight, layer.weight[0].numel(), generator)
            layer.bias.zero_()
    module.to(device)
    # Fused Adam: one arithmetic on the card and the CPU.
    optimizer = torch.optim.Adam(module.parameters(), lr=1e-3, fused=True)
    x = torch.as_tensor(images, device=device)
    y = torch.as_tensor(labels, device=device).long()
    n = len(images)
    loss = torch.zeros(())
    with full_f32_matmul():
        for i in range(steps):
            lo = (i * batch_size) % n
            logits = module({"image": x[lo:lo + batch_size]}, training=True)
            loss = F.cross_entropy(logits, y[lo:lo + batch_size])
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
            optimizer.step()
    state = {key: value.detach().cpu().clone() for key, value in module.state_dict().items()}
    return state, float(loss.detach())


def input_fn(images, labels, batch_size=128):
    def fn():
        for lo in range(0, len(images), batch_size):
            yield {"image": images[lo:lo + batch_size]}, labels[lo:lo + batch_size]

    return fn


def make_estimator(pretrained, search_steps: int, iterations: int, model_dir: str, device=None):
    """The three-candidate AutoEnsembleEstimator over `pretrained`."""
    return AutoEnsembleEstimator(
        head=MultiClassHead(n_classes=10),
        candidate_pool={
            # Frozen transfer: trained weights, never updated.
            "pretrained_frozen": AutoEnsembleSubestimator(
                ConvEncoder(), prediction_only=True, initial_variables=pretrained
            ),
            # Fine-tuned transfer: same weights, trainable.
            "pretrained_finetune": AutoEnsembleSubestimator(
                ConvEncoder(),
                optimizer=lambda params: torch.optim.Adam(params, lr=3e-4, fused=True),
                initial_variables=pretrained,
            ),
            # From-scratch baseline candidate.
            "linear": AutoEnsembleSubestimator(
                LinearModel(), optimizer=lambda params: torch.optim.Adam(params, lr=1e-3, fused=True)
            ),
        },
        max_iteration_steps=search_steps,
        max_iterations=iterations,
        ensemblers=[
            ComplexityRegularizedEnsembler(
                optimizer=lambda params: torch.optim.Adam(params, lr=1e-3, fused=True), use_fused_combine=True
            )
        ],
        model_dir=model_dir,
        log_every_steps=0,
        device=device,
    )


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--pretrain_steps", type=int, default=300)
    parser.add_argument("--search_steps", type=int, default=200)
    parser.add_argument("--iterations", type=int, default=2)
    parser.add_argument("--model_dir", default=None)
    parser.add_argument("--device", default=None, help="the card by default; 'cpu' to run on the CPU")
    args = parser.parse_args(argv)

    # Source task: clean digits. Target task: noisy shifted digits.
    src_x, src_y = make_dataset(4096, noise=0.1, max_shift=0, seed=3)
    tgt_x, tgt_y = make_dataset(4096, noise=0.6, max_shift=2, seed=7)
    tst_x, tst_y = make_dataset(1024, noise=0.6, max_shift=2, seed=8)

    print("Pretraining the source module (%d steps)..." % args.pretrain_steps)
    pretrained, src_loss = pretrain(src_x, src_y, args.pretrain_steps, device=args.device)
    print("  source loss: %.4f" % src_loss)

    est = make_estimator(
        pretrained, args.search_steps, args.iterations, args.model_dir or tempfile.mkdtemp("transfer"), args.device
    )
    est.train(input_fn(tgt_x, tgt_y), max_steps=10**9)
    metrics = est.evaluate(input_fn(tst_x, tst_y))
    print("Target-task test accuracy: %.4f (best ensemble: %s)" % (metrics["accuracy"], metrics["best_ensemble"]))
    with open(os.path.join(est.model_dir, "architecture-0.json")) as f:
        members = [s["builder_name"] for s in json.load(f)["subnetworks"]]
    print("Iteration-0 winner members: %s" % members)
    return metrics


if __name__ == "__main__":
    main()
