"""Per-role runner for the port's chief/worker test.

    python tests/torch_distributed_runner.py MODEL_DIR ROLE [train|timeout] [DEVICE]

The port's copy of tests/distributed_runner.py: each role is its own
process (no process group) sharing MODEL_DIR, its role set with
`coordination.set_process_index_for_testing`. Both train the same
deterministic search; the chief (role 0) writes every iteration's
bookkeeping and the worker waits for its manifest. In `timeout` mode a
worker alone must see `WorkerWaitTimeout` come out of `train()` within
its 3 s wait.
"""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from adanet_tpu_torch.core.estimator import Estimator  # noqa: E402
from adanet_tpu_torch.core.heads import RegressionHead  # noqa: E402
from adanet_tpu_torch.distributed import coordination  # noqa: E402
from adanet_tpu_torch.ensemble import ComplexityRegularizedEnsembler  # noqa: E402
from adanet_tpu_torch.subnetwork.generator import SimpleGenerator  # noqa: E402

from torch_port_common import dnn_builder, linear_dataset  # noqa: E402


def main(argv):
    model_dir, role = argv[0], int(argv[1])
    mode = argv[2] if len(argv) > 2 else "train"
    device = argv[3] if len(argv) > 3 else "cpu"
    torch.set_num_threads(1)
    coordination.set_process_index_for_testing(role)
    estimator = Estimator(
        head=RegressionHead(),
        subnetwork_generator=SimpleGenerator([dnn_builder("dnn", 1), dnn_builder("deep", 2)]),
        max_iteration_steps=6,
        ensemblers=[ComplexityRegularizedEnsembler(optimizer=lambda p: torch.optim.SGD(p, lr=0.05))],
        max_iterations=2,
        model_dir=model_dir,
        log_every_steps=0,
        device=device,
        worker_wait_timeout_secs=3.0 if mode == "timeout" else 120.0,
    )
    if mode == "timeout":
        try:
            estimator.train(linear_dataset(), max_steps=100)
        except coordination.WorkerWaitTimeout:
            print("ROLE %d TIMED OUT CLEANLY" % role, flush=True)
            return
        raise AssertionError("worker did not time out")
    estimator.train(linear_dataset(), max_steps=100)
    assert estimator.latest_iteration_number() == 2, estimator.latest_iteration_number()
    metrics = estimator.evaluate(linear_dataset())
    assert np.isfinite(metrics["average_loss"]), metrics
    print("ROLE %d DONE" % role, flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
