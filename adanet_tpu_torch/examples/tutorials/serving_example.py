"""Export-and-serve walkthrough: train, export, serve without model code.

Port of adanet_tpu/examples/tutorials/serving_example.py. Trains a tiny
multi-head search, exports the winning ensemble
(`Estimator.export_saved_model`: a hermetic `torch.export` program,
`serving.pt2`), then serves it from a separate OS process that imports
only torch, numpy and `adanet_tpu_torch.ops`, with a polymorphic batch
dimension (batch sizes 1 and 7).

Where the JAX program needs nothing beyond jax, the served process here
imports `adanet_tpu_torch.ops`: that import registers the kernels'
custom ops (`adanet_tpu_torch::weighted_combine`, K1, and
`adanet_tpu_torch::sep_conv`, K2), which the program calls, and nothing
of the builders, the generator or the models.

Run: python -m adanet_tpu_torch.examples.tutorials.serving_example [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch
from torch import nn

from adanet_tpu_torch.core.estimator import Estimator
from adanet_tpu_torch.core.heads import MultiClassHead, MultiHead, RegressionHead
from adanet_tpu_torch.ensemble.weighted import ComplexityRegularizedEnsembler
from adanet_tpu_torch.subnetwork.generator import Builder, SimpleGenerator, Subnetwork


class _TwoHead(nn.Module):
    def __init__(self, hidden: int, logits_dimension):
        super().__init__()
        self.trunk = nn.Linear(4, hidden)
        self.names = sorted(logits_dimension)
        self.heads = nn.ModuleDict({name: nn.Linear(hidden, logits_dimension[name]) for name in self.names})
        self.complexity = float(hidden) ** 0.5

    def forward(self, features, training: bool = False):
        x = torch.relu(self.trunk(features["x"].float()))
        return Subnetwork(
            last_layer=x,
            logits={name: self.heads[name](x) for name in self.names},
            complexity=self.complexity,
        )


class TwoHeadBuilder(Builder):
    """One trunk, two output heads (regression + 3-class)."""

    def __init__(self, name: str, hidden: int):
        self._name = name
        self._hidden = hidden

    @property
    def name(self):
        return self._name

    def build_subnetwork(self, logits_dimension, previous_ensemble=None, *, input_shape=None):
        return _TwoHead(self._hidden, logits_dimension)

    def build_train_optimizer(self, previous_ensemble=None):
        return lambda named: torch.optim.SGD([p for _, p in named], lr=0.05)


def input_fn():
    rng = np.random.RandomState(0)
    for _ in range(8):
        x = rng.randn(32, 4).astype(np.float32)
        yield (
            {"x": x},
            {"reg": x @ np.ones((4, 1), np.float32), "cls": (x[:, 0] > 0).astype(np.int32) + (x[:, 1] > 0)},
        )


# The serving process: ONLY torch, numpy and the kernels' custom ops.
_SERVE_SNIPPET = """
import json, sys
import numpy as np
import torch
import adanet_tpu_torch.ops  # registers the custom ops the program calls

torch.backends.cudnn.allow_tf32 = False
program = torch.export.load(sys.argv[1] + "/serving.pt2").module()
device = torch.device(sys.argv[2])
for batch_size in (1, 7):
    x = np.random.RandomState(1).randn(batch_size, 4).astype(np.float32)
    with torch.inference_mode():
        out = program({"x": torch.from_numpy(x).to(device)})
    shapes = {k: list(v.shape) for k, v in out.items() if torch.is_tensor(v)}
    print(json.dumps({"batch_size": batch_size, "outputs": shapes}))
port = sorted(m for m in sys.modules if m.startswith("adanet_tpu_torch"))
print(json.dumps({"modules": port}))
"""


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--max_steps", type=int, default=24)
    parser.add_argument("--iterations", type=int, default=2)
    parser.add_argument("--device", default=None, help="the card by default; 'cpu' to run on the CPU")
    args = parser.parse_args(argv)

    est = Estimator(
        head=MultiHead([RegressionHead(name="reg"), MultiClassHead(3, name="cls")]),
        subnetwork_generator=SimpleGenerator([TwoHeadBuilder("narrow", 8), TwoHeadBuilder("wide", 16)]),
        max_iteration_steps=args.max_steps // (2 * args.iterations) or 1,
        ensemblers=[ComplexityRegularizedEnsembler(optimizer=lambda params: torch.optim.SGD(params, lr=0.01))],
        max_iterations=args.iterations,
        model_dir=tempfile.mkdtemp(prefix="adanet_serving_"),
        log_every_steps=0,
        device=args.device,
    )
    est.train(input_fn, max_steps=args.max_steps)
    print("trained:", est.latest_iteration_number(), "iterations")

    export_dir = est.export_saved_model(os.path.join(est.model_dir, "export"), next(input_fn()))
    print("exported:", sorted(os.listdir(export_dir)))

    root = os.path.dirname(os.path.dirname(os.path.abspath(sys.modules["adanet_tpu_torch"].__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, [root, os.environ.get("PYTHONPATH")])))
    device = "cuda" if args.device is None else args.device
    result = subprocess.run([sys.executable, "-c", _SERVE_SNIPPET, export_dir, device], capture_output=True, text=True,
                            check=True, env=env, timeout=600)
    lines = [json.loads(line) for line in result.stdout.strip().splitlines()]
    for served in lines[:-1]:
        print("served batch", served["batch_size"], "->", served["outputs"])
    modules = lines[-1]["modules"]
    builders = [m for m in modules if not m.startswith(("adanet_tpu_torch.ops", "adanet_tpu_torch.store",
                                                          "adanet_tpu_torch.robustness",
                                                          "adanet_tpu_torch.observability"))
                and m not in ("adanet_tpu_torch", "adanet_tpu_torch._device")]
    if builders:
        raise SystemExit("the serving process imported model code: %s" % builders)
    print("served with %d modules of the port, none of them model code" % len(modules))
    print("OK: hermetic multi-head serving round trip")
    return lines


if __name__ == "__main__":
    main()
