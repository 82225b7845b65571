"""Searcher process of the port's serve-while-search chaos gate (the
port's copy of tests/serving_search_runner.py).

    python tests/torch_serving_search_runner.py MODEL_DIR MAX_ITERATIONS

Runs a deterministic search on the CPU with `export_serving=True` on a
model dir that the parent process serves from: builders "dnn" (one
layer) and "deep" (two), 4 steps an iteration, a regression head, one
serving generation published per completed iteration. A chaos run arms a
fault through `ADANET_FAULTS` (`checkpoint.write:torn:after=1` tears
iteration 1's frozen payload and SIGKILLs this process); a run without
faults heals and resumes from the durable chain. Prints `SEARCH DONE
<iterations>` at the end.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from adanet_tpu_torch.core.estimator import Estimator  # noqa: E402
from adanet_tpu_torch.core.heads import RegressionHead  # noqa: E402
from adanet_tpu_torch.ensemble import ComplexityRegularizedEnsembler  # noqa: E402
from adanet_tpu_torch.subnetwork.generator import SimpleGenerator  # noqa: E402

from torch_port_common import dnn_builder, linear_dataset  # noqa: E402


def main():
    model_dir, max_iterations = sys.argv[1], int(sys.argv[2])
    torch.set_num_threads(1)
    est = Estimator(
        head=RegressionHead(),
        subnetwork_generator=SimpleGenerator([dnn_builder("dnn", 1), dnn_builder("deep", 2)]),
        max_iteration_steps=4,
        ensemblers=[ComplexityRegularizedEnsembler(optimizer=lambda p: torch.optim.SGD(p, lr=0.05))],
        max_iterations=max_iterations,
        model_dir=model_dir,
        log_every_steps=0,
        save_checkpoint_steps=None,
        export_serving=True,
        device="cpu",
    )
    est.train(linear_dataset(), max_steps=10**6)
    print("SEARCH DONE", est.latest_iteration_number(), flush=True)


if __name__ == "__main__":
    main()
