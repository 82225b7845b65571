"""Elastic work-queue runner for the port: a lease-based search in one
or several processes.

    python tests/torch_elastic_wq_runner.py MODEL_DIR TAG RANK PORT WORLD MAX_STEPS [DEVICE [BACKEND]]

The port's copy of tests/elastic_wq_runner.py, spawned by
`test_torch_elastic_processes.py` (2 -> 1 -> 2 against a never-shrunk
oracle; a worker SIGKILLed mid-unit by the armed `workunit.execute`
fault, whose unit re-issues to the chief after the lease TTL) and by
`chip_smoke.py` on the card. One invocation runs one phase of the
search; `MAX_STEPS` -1 runs it to the end.

Every process feeds the IDENTICAL full batch stream, the elastic
scheduler's data contract: a unit's batches are a function of its
absolute steps, so a unit re-issued to a survivor, or run in a world of
another size, reads the same data. With `TEST_PLACEMENT=rr` the same
search runs under lockstep RoundRobin in one process (the oracle),
windows of 4 steps like the elastic units. `TEST_LEASE_TTL` sets the
lease TTL (3 s by default); `TEST_CHIEF_UNIT_DELAY` (seconds) makes
the chief sleep before each unit it executes, so that a worker that
reaches the queue late still finds units to claim (a delay changes no
number: a unit's result is a function of its snapshot and steps alone);
`ADANET_TEST_EXIT_BARRIER=1` makes the
chief wait for every worker's exit flag before it leaves (the store
lives in its process). With `TEST_SEARCH=digits` the search is
`chip_smoke.py`'s `elastic_search` (`digits_search`). Rank 0 writes
`<TAG>.json` (steps, iteration, its launch counts, with a completed
search the selection sequence, the evaluation and a digest of every
frozen payload's numbers) and every process prints `ELASTIC WQ ROLE
<rank> DONE` with each drain's dispatched and reused steps and its
launch counts (counters zeroed just before `train`).
"""

import hashlib
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from adanet_tpu_torch.core import checkpoint as ckpt_lib  # noqa: E402
from adanet_tpu_torch.core.estimator import Estimator  # noqa: E402
from adanet_tpu_torch.core.heads import RegressionHead  # noqa: E402
from adanet_tpu_torch.distributed import coordination  # noqa: E402
from adanet_tpu_torch.distributed.placement import ElasticWorkQueueStrategy, RoundRobinStrategy  # noqa: E402
from adanet_tpu_torch.ensemble import ComplexityRegularizedEnsembler  # noqa: E402
from adanet_tpu_torch.subnetwork.generator import SimpleGenerator  # noqa: E402

from torch_elastic_runner import selection_sequence  # noqa: E402
from torch_port_common import dnn_builder  # noqa: E402


def full_batches():
    """Deterministic 16-row batches, identical on every process."""
    rng = np.random.RandomState(7)
    while True:
        x = rng.randn(16, 4).astype(np.float32)
        y = (x @ np.ones((4, 1), np.float32)) + 0.1
        yield {"x": x}, y


def frozen_digest(model_dir):
    """SHA-256 over every completed iteration's frozen payload tensors, in
    order: equal digests mean bitwise equal frozen parameters."""
    digest = hashlib.sha256()
    t = 0
    while os.path.exists(os.path.join(model_dir, ckpt_lib.frozen_filename(t))):
        payload = ckpt_lib.restore_payload(model_dir, ckpt_lib.frozen_filename(t))
        stack = [payload]
        while stack:
            node = stack.pop()
            if isinstance(node, dict):
                stack.extend(node[k] for k in sorted(node, key=str, reverse=True))
            elif isinstance(node, (list, tuple)):
                stack.extend(reversed(node))
            elif torch.is_tensor(node):
                digest.update(node.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes())
        t += 1
    return digest.hexdigest()


def digits_search(model_dir, device):
    """`chip_smoke.py`'s `train_search` configuration (4096/1024 digits,
    simple_dnn 128 wide, fused Adam, K1 on, 2 x 400 steps of 128) under
    `ElasticWorkQueueStrategy(window_steps=8, speculate_steps=8)`, as its
    `elastic_search` phase runs it in one process. Returns (the
    Estimator, the training input_fn, the test input_fn)."""
    import chip_smoke

    from adanet_tpu_torch.examples.synthetic_digits import input_fn, make_dataset

    head, generator, ensembler = chip_smoke.search_parts()
    xtr, ytr = make_dataset(chip_smoke.TRAIN_EXAMPLES, seed=7)
    xte, yte = make_dataset(chip_smoke.EVAL_EXAMPLES, seed=8)
    strategy = ElasticWorkQueueStrategy(
        window_steps=chip_smoke.ELASTIC_WINDOW, speculate_steps=chip_smoke.ELASTIC_WINDOW,
        lease_ttl_secs=float(os.environ.get("TEST_LEASE_TTL", "15")), devices=[torch.device(device)],
    )
    est = Estimator(head, generator, max_iteration_steps=chip_smoke.TRAIN_STEPS,
                    max_iterations=chip_smoke.TRAIN_ITERATIONS, ensemblers=[ensembler], model_dir=model_dir,
                    log_every_steps=0, device=device, placement_strategy=strategy)
    return (est, input_fn(xtr, ytr, chip_smoke.TRAIN_BATCH), input_fn(xte, yte, chip_smoke.TRAIN_BATCH))


def build(model_dir, device):
    if os.environ.get("TEST_PLACEMENT") == "rr":
        placement = RoundRobinStrategy([torch.device(device)])
    else:
        placement = ElasticWorkQueueStrategy(
            window_steps=4, unit_devices=1, lease_ttl_secs=float(os.environ.get("TEST_LEASE_TTL", "3")),
            devices=[torch.device(device)],
        )
    return Estimator(
        head=RegressionHead(),
        subnetwork_generator=SimpleGenerator(
            [dnn_builder("d1", hidden=4, learning_rate=0.05), dnn_builder("d2", hidden=8, learning_rate=0.05)]
        ),
        max_iteration_steps=20,
        max_iterations=2,
        iterations_per_loop=4,
        ensemblers=[ComplexityRegularizedEnsembler(optimizer=lambda p: torch.optim.SGD(p, lr=0.05))],
        model_dir=model_dir,
        log_every_steps=0,
        device=device,
        placement_strategy=placement,
    )


def main(argv):
    model_dir, tag, rank, port, world, max_steps = argv[:6]
    rank, world, max_steps = int(rank), int(world), int(max_steps)
    device = argv[6] if len(argv) > 6 else "cpu"
    backend = argv[7] if len(argv) > 7 else None
    torch.set_num_threads(1)
    if world > 1:
        # The queue needs no device collective; the process group is for
        # its store.
        coordination.initialize("localhost:%s" % port, world, rank, device=device, backend=backend)
    from adanet_tpu_torch import ops
    from adanet_tpu_torch.distributed.scheduler import ElasticWorkQueueExecutor

    drains = []
    run_iteration = ElasticWorkQueueExecutor.run_iteration

    def counted(self, *args, **kwargs):
        result = run_iteration(self, *args, **kwargs)
        drains.append([result.dispatched_steps, result.reused_steps])
        return result

    ElasticWorkQueueExecutor.run_iteration = counted
    delay = float(os.environ.get("TEST_CHIEF_UNIT_DELAY", "0"))
    if delay and rank == 0:
        import time

        def delayed(run_unit):
            def run(self, *args, **kwargs):
                time.sleep(delay)
                return run_unit(self, *args, **kwargs)

            return run

        ElasticWorkQueueExecutor._run_subnetwork_unit = delayed(ElasticWorkQueueExecutor._run_subnetwork_unit)
        ElasticWorkQueueExecutor._run_ensemble_unit = delayed(ElasticWorkQueueExecutor._run_ensemble_unit)
    digits = os.environ.get("TEST_SEARCH") == "digits"
    if digits:
        est, train_fn, test_fn = digits_search(model_dir, device)
    else:
        est, train_fn, test_fn = build(model_dir, device), lambda: iter(full_batches()), lambda: iter(full_batches())
    start_step = est.latest_global_step()
    ops.reset_launch_counts()
    est.train(train_fn, max_steps=None if max_steps < 0 else max_steps)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    record = {
        "resume_start_step": start_step,
        "final_step": est.latest_global_step(),
        "final_iteration": est.latest_iteration_number(),
        "world": world,
        "launches": ops.launch_counts(),
    }
    if max_steps < 0 and rank == 0:
        metrics = est.evaluate(test_fn) if digits else est.evaluate(test_fn, steps=4)
        record["loss"] = float(metrics["average_loss"])
        record["accuracy"] = metrics.get("accuracy")
        record["selection"] = selection_sequence(model_dir)
        record["frozen_digest"] = frozen_digest(model_dir)
    if rank == 0:
        with open(os.path.join(model_dir, "%s.json" % tag), "w") as f:
            json.dump(record, f)
    print("ELASTIC WQ ROLE %d DONE %s" % (rank, json.dumps({"drains": drains, "launches": record["launches"]})),
          flush=True)
    if os.environ.get("ADANET_TEST_EXIT_BARRIER"):
        # Opt-in: with a SIGKILLed worker the chief must not wait for its
        # flag.
        coordination.leave()
    else:
        coordination.shutdown(timeout_secs=10.0)
    sys.stdout.flush()
    os._exit(0)


if __name__ == "__main__":
    main(sys.argv[1:])
