"""Elastic resume runner for the port: one search trained by worlds of
changing size, data-parallel.

    python tests/torch_elastic_runner.py MODEL_DIR TAG RANK PORT WORLD MAX_STEPS [DEVICE [BACKEND]]

The port's copy of tests/elastic_runner.py, spawned by
`test_torch_elastic_processes.py` (2 -> 1, and 2 -> 1 -> 2 against a
never-shrunk oracle). Each invocation runs one phase of the same search
on a shared MODEL_DIR under the default placement (data-parallel across
processes); `MAX_STEPS` -1 runs it to the end. Each process feeds its
contiguous shard of a fixed 16-row global batch, so the global stream
is the same whatever the world's size. Rank 0 writes `<TAG>.json` with
the phase's first and last step and, when the search completed, the
selection sequence and an evaluation loss.

With `TEST_RESTORE_FAULT=<rank>` the phase is the restore agreement's
check: that rank's read of the mid-iteration state file fails
(`CheckpointCorruptionError`, as bit rot would), every rank writes
`restore_<rank>.json` (the global step and state file it resumed from,
and the quarantines and manifest writes it made while restoring), and
the processes leave together without training.
"""

import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from adanet_tpu_torch.core import checkpoint as ckpt_lib  # noqa: E402
from adanet_tpu_torch.core import estimator as estimator_lib  # noqa: E402
from adanet_tpu_torch.core.heads import RegressionHead  # noqa: E402
from adanet_tpu_torch.distributed import coordination  # noqa: E402
from adanet_tpu_torch.ensemble import ComplexityRegularizedEnsembler  # noqa: E402
from adanet_tpu_torch.subnetwork.generator import SimpleGenerator  # noqa: E402

from torch_port_common import dnn_builder  # noqa: E402


def local_batches(world: int, rank: int):
    """Deterministic 16-row global batches; this process's shard."""
    rng = np.random.RandomState(7)
    shard = 16 // world
    lo, hi = rank * shard, (rank + 1) * shard
    while True:
        x = rng.randn(16, 4).astype(np.float32)
        y = (x @ np.ones((4, 1), np.float32)) + 0.1
        yield {"x": x[lo:hi]}, y[lo:hi]


def selection_sequence(model_dir):
    """[(candidate name, subnetworks)] of every completed iteration."""
    out = []
    t = 0
    while os.path.exists(os.path.join(model_dir, "architecture-%d.json" % t)):
        with open(os.path.join(model_dir, "architecture-%d.json" % t)) as f:
            obj = json.load(f)
        out.append([obj.get("ensemble_candidate_name"), obj.get("subnetworks")])
        t += 1
    return out


def build(model_dir, device):
    return estimator_lib.Estimator(
        head=RegressionHead(),
        subnetwork_generator=SimpleGenerator(
            [dnn_builder("d1", hidden=4, learning_rate=0.05), dnn_builder("d2", hidden=8, learning_rate=0.05)]
        ),
        max_iteration_steps=20,
        max_iterations=2,
        ensemblers=[ComplexityRegularizedEnsembler(optimizer=lambda p: torch.optim.SGD(p, lr=0.05))],
        model_dir=model_dir,
        log_every_steps=0,
        save_checkpoint_steps=5,
        device=device,
    )


def restore_check(model_dir, rank, faulty_rank):
    """Arms the faulty rank's state read, records what each rank's
    restore did, and leaves without training."""
    writes = []
    quarantine, write_manifest = ckpt_lib.quarantine_file, ckpt_lib.write_manifest
    restore_payload = ckpt_lib.restore_payload

    def failing_restore(directory, filename):
        if filename.startswith("ckpt-"):
            raise ckpt_lib.CheckpointCorruptionError(os.path.join(directory, filename), "injected rot")
        return restore_payload(directory, filename)

    def recording(name, fn):
        def wrapped(*args, **kwargs):
            writes.append(name)
            return fn(*args, **kwargs)

        return wrapped

    original = estimator_lib.Estimator._init_or_restore_state

    def restore(self, iteration, sample_batch, info, training=True):
        state_file = info.iteration_state_file
        if rank == faulty_rank:
            ckpt_lib.restore_payload = failing_restore
        ckpt_lib.quarantine_file = recording("quarantine", quarantine)
        ckpt_lib.write_manifest = recording("manifest", write_manifest)
        try:
            state = original(self, iteration, sample_batch, info, training)
        finally:
            ckpt_lib.restore_payload = restore_payload
            ckpt_lib.quarantine_file, ckpt_lib.write_manifest = quarantine, write_manifest
        with open(os.path.join(model_dir, "restore_%d.json" % rank), "w") as f:
            json.dump({"state_file": state_file, "global_step": info.global_step,
                       "iteration_step": int(state.iteration_step), "writes": writes}, f)
        coordination.leave()
        sys.stdout.flush()
        os._exit(0)

    estimator_lib.Estimator._init_or_restore_state = restore


def main(argv):
    model_dir, tag, rank, port, world, max_steps = argv[:6]
    rank, world, max_steps = int(rank), int(world), int(max_steps)
    device = argv[6] if len(argv) > 6 else "cpu"
    backend = argv[7] if len(argv) > 7 else None
    torch.set_num_threads(1)
    if world > 1:
        coordination.initialize("localhost:%s" % port, world, rank, device=device, backend=backend)
    if os.environ.get("TEST_RESTORE_FAULT"):
        restore_check(model_dir, rank, int(os.environ["TEST_RESTORE_FAULT"]))
    est = build(model_dir, device)
    start_step = est.latest_global_step()
    est.train(lambda: local_batches(world, rank), max_steps=None if max_steps < 0 else max_steps)
    record = {
        "resume_start_step": start_step,
        "final_step": est.latest_global_step(),
        "final_iteration": est.latest_iteration_number(),
        "world": world,
    }
    if max_steps < 0:  # ran to the end: selection sequence and evaluation
        record["loss"] = float(est.evaluate(lambda: local_batches(world, rank), steps=4)["average_loss"])
        record["selection"] = selection_sequence(model_dir)
    if rank == 0:
        with open(os.path.join(model_dir, "%s.json" % tag), "w") as f:
            json.dump(record, f)
    print("ELASTIC ROLE %d DONE" % rank, flush=True)
    coordination.leave()
    sys.stdout.flush()
    os._exit(0)


if __name__ == "__main__":
    main(sys.argv[1:])
