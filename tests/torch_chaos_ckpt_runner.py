"""A writer SIGKILLed mid-checkpoint, leaving a torn file (the port's copy
of tests/chaos_ckpt_runner.py).

Spawned by `test_torch_resume.py` with `ADANET_FAULTS=
"checkpoint.write:torn:after=2"`: the third payload write (the step-6
mid-iteration checkpoint) writes a truncated prefix directly at the
final path, the on-disk result of a crash without atomic rename, and
SIGKILLs the process. The manifest still points at the intact step-4
checkpoint; the torn `ckpt-6.pt` is an orphan that the resume's fsck
must quarantine. The parent test's uninterrupted run and its resume use
`build_estimator` and `input_fn` from here.
"""

import sys

import numpy as np
import torch

from adanet_tpu_torch.core.estimator import Estimator
from adanet_tpu_torch.core.heads import MultiClassHead
from adanet_tpu_torch.ensemble.weighted import ComplexityRegularizedEnsembler
from adanet_tpu_torch.examples import simple_dnn
from adanet_tpu_torch.subnetwork.generator import SimpleGenerator

_RNG = np.random.RandomState(3)
_X = _RNG.randn(16, 8).astype(np.float32)
BATCH = ({"x": _X}, (_X[:, :3].argmax(axis=1)).astype(np.int32))


def sgd(params):
    return torch.optim.SGD(params, lr=0.05)


def build_estimator(model_dir):
    """Builders "a" (one layer) and "b" (two), 6 steps an iteration, 2
    iterations, a checkpoint every 2 steps."""
    builders = [simple_dnn._DNNBuilder(sgd, 8, n, False, 0.0, 0) for n in (1, 2)]
    return Estimator(
        head=MultiClassHead(3),
        subnetwork_generator=SimpleGenerator(builders),
        max_iteration_steps=6,
        ensemblers=[ComplexityRegularizedEnsembler(optimizer=sgd)],
        max_iterations=2,
        model_dir=model_dir,
        log_every_steps=0,
        save_checkpoint_steps=2,
        device="cpu",
    )


def input_fn():
    """One fixed batch forever."""
    while True:
        yield BATCH


def main():
    torch.set_num_threads(1)
    est = build_estimator(sys.argv[1])
    est.train(input_fn, max_steps=100)
    # The armed torn-write fault must have killed the process at step 6.
    print("UNEXPECTED COMPLETION", flush=True)


if __name__ == "__main__":
    main()
