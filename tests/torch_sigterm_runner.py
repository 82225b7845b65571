"""Preemption runner for the port: trains until SIGTERM, then must exit cleanly.

Spawned by `test_torch_resume.py::test_sigterm_checkpoints_and_resumes`
(the port's copy of tests/sigterm_runner.py). Prints READY once training
has started, so that the parent knows when to signal, and STOPPED AT
with the manifest's global step once `train` has returned.
"""

import sys

import numpy as np
import torch

from adanet_tpu_torch.core.estimator import Estimator
from adanet_tpu_torch.core.heads import MultiClassHead
from adanet_tpu_torch.ensemble.weighted import ComplexityRegularizedEnsembler
from adanet_tpu_torch.examples import simple_dnn
from adanet_tpu_torch.subnetwork.generator import SimpleGenerator


def sgd(params):
    return torch.optim.SGD(params, lr=0.05)


def build_estimator(model_dir, max_iteration_steps, **kwargs):
    """The runner's search, also resumed by the parent test: one simple_dnn
    candidate on 16-dimensional features, 4 classes."""
    return Estimator(
        head=MultiClassHead(4),
        subnetwork_generator=SimpleGenerator([simple_dnn._DNNBuilder(sgd, 8, 1, False, 0.0, 0)]),
        max_iteration_steps=max_iteration_steps,
        ensemblers=[ComplexityRegularizedEnsembler(optimizer=sgd)],
        model_dir=model_dir,
        log_every_steps=0,
        device="cpu",
        **kwargs,
    )


def make_input_fn(on_pull=None):
    def input_fn():
        rng = np.random.RandomState(0)
        while True:
            if on_pull is not None:
                on_pull()
            x = rng.randn(16, 16).astype(np.float32)
            yield {"x": x}, (x[:, :4].argmax(axis=1)).astype(np.int32)

    return input_fn


def main():
    torch.set_num_threads(1)
    model_dir = sys.argv[1]
    pulls = [0]

    def on_pull():
        pulls[0] += 1
        # One batch a step (plus the sample pull): by the 20th, steps
        # are flowing and it is safe for the parent to preempt.
        if pulls[0] == 20:
            print("READY", flush=True)

    est = build_estimator(model_dir, 10**6)  # far beyond the signal
    est.train(make_input_fn(on_pull))  # runs until the signal stops it
    print("STOPPED AT", est.latest_global_step(), flush=True)


if __name__ == "__main__":
    main()
