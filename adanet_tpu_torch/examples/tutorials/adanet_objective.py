"""The AdaNet objective, hands on: how λ steers candidate selection.

Port of adanet_tpu/examples/tutorials/adanet_objective.py: run the same
two-candidate search (a shallow, cheap and a deep, expensive simple_dnn
subnetwork) under different complexity penalties λ and watch the
objective

    F(w) = loss + Σ_j (λ · r(h_j) + β) |w_j|

change which architecture the search selects. With λ=0 the search is free
to pick whatever trains best (usually the deep candidate); with a large λ
the deep candidate must earn its capacity.

Run: python -m adanet_tpu_torch.examples.tutorials.adanet_objective \\
        [--steps 300] [--lambdas 0.0,0.3,1.0] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import torch

from adanet_tpu_torch.core.estimator import Estimator
from adanet_tpu_torch.core.heads import MultiClassHead
from adanet_tpu_torch.ensemble.weighted import ComplexityRegularizedEnsembler
from adanet_tpu_torch.examples import simple_dnn
from adanet_tpu_torch.examples.synthetic_digits import input_fn, make_dataset


def _adam(params):
    # Fused Adam: one arithmetic on the card and the CPU.
    return torch.optim.Adam(params, lr=1e-3, fused=True)


def run_search(lam, train, test, steps, model_dir, device=None):
    """One 2-iteration search at complexity penalty `lam`; returns (the
    builder names of the final ensemble, its test accuracy)."""
    xtr, ytr = train
    xte, yte = test
    est = Estimator(
        head=MultiClassHead(n_classes=10),
        # simple_dnn proposes a same-depth and a depth+1 candidate per
        # iteration with complexity sqrt(depth): exactly the simple-vs-
        # complex pair the objective arbitrates.
        subnetwork_generator=simple_dnn.Generator(
            optimizer_fn=_adam, layer_size=64, initial_num_layers=1, seed=0
        ),
        max_iteration_steps=steps,
        max_iterations=2,
        # The mixture weights combine through K1 (use_fused_combine).
        ensemblers=[ComplexityRegularizedEnsembler(optimizer=_adam, adanet_lambda=lam, use_fused_combine=True)],
        model_dir=model_dir,
        log_every_steps=0,
        device=device,
    )
    est.train(input_fn(xtr, ytr), max_steps=10**9)
    metrics = est.evaluate(input_fn(xte, yte))
    with open(os.path.join(model_dir, "architecture-1.json")) as f:
        architecture = json.load(f)
    members = [entry["builder_name"] for entry in architecture.get("subnetworks", [])]
    return members, float(metrics["accuracy"])


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=300)
    parser.add_argument("--train_size", type=int, default=4096)
    # 0.0 -> the deep candidates win; 1.0 -> capacity is priced out and
    # the search keeps shallow members.
    parser.add_argument("--lambdas", default="0.0,0.3,1.0")
    parser.add_argument("--model_dir", default=None)
    parser.add_argument("--device", default=None, help="the card by default; 'cpu' to run on the CPU")
    args = parser.parse_args(argv)

    train = make_dataset(args.train_size, seed=7)
    test = make_dataset(1024, seed=8)
    base_dir = args.model_dir or tempfile.mkdtemp(prefix="adanet_objective_")

    results = {}
    for lam_str in args.lambdas.split(","):
        lam = float(lam_str)
        members, accuracy = run_search(
            lam, train, test, args.steps, os.path.join(base_dir, "lambda_%s" % lam_str.strip()), args.device
        )
        results[lam] = (members, accuracy)
        print("lambda=%-6s members=%-40s accuracy=%.3f" % (lam, ",".join(members), accuracy))

    print(
        "\nThe complexity penalty prices capacity: as lambda grows, the "
        "search only keeps deeper members when their accuracy gain beats "
        "lambda * sqrt(depth) * |w|."
    )
    return results


if __name__ == "__main__":
    main()
