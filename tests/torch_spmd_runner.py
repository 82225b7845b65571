"""Data-parallel runner for the port: one OS process a rank.

    python tests/torch_spmd_runner.py MODE MODEL_DIR RANK PORT WORLD [DEVICE [BACKEND]]

The port's copy of tests/spmd_runner.py and tests/lockstep_runner.py.
The processes join one `torch.distributed` process group at
`localhost:PORT` (`distributed.coordination.initialize`; DEVICE "cpu"
by default, BACKEND by the stated rule unless given) and:

- `spmd`: train one search data-parallel, each process feeding its
  contiguous slice of every 16-row global batch (`full_batches`), with a
  collective Evaluator and ReportMaterializer; each writes
  `probe_<rank>.npz` with the final winner's member parameters, so that
  the caller can check that the processes agree bitwise and match a
  one-process oracle on the whole batches (`oracle_probes`), and prints
  its kernels' launch counts.
- `bagging`: tests/spmd_bagging_runner.py's AutoEnsemble search (an
  MLP with its own `train_input_fn`, a linear candidate, 6 steps), each
  process feeding its half of BOTH streams; each writes
  `bagging_<rank>.npz` with both candidates' trained parameters
  (`bagging_probes`), for the caller to hold the processes bitwise
  equal and against one process on the whole streams.
- `sigterm`: train a long search until a SIGTERM to any one process;
  every process prints `STOPPED AT <steps>` (the steps it trained).
- `lockstep-ok`, `lockstep-count`, `lockstep-shape`: a collective
  Evaluator pass whose per-process streams agree, or differ in length or
  in a batch's shape; the guard must raise on every process
  (`LOCKSTEP <mode> ROLE <rank> RAISED`), or pass (`OK`).
"""

import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))

import torch  # noqa: E402

from adanet_tpu_torch.core.estimator import Estimator  # noqa: E402
from adanet_tpu_torch.core.evaluator import Evaluator  # noqa: E402
from adanet_tpu_torch.core.heads import RegressionHead  # noqa: E402
from adanet_tpu_torch.core.report_materializer import ReportMaterializer  # noqa: E402
from adanet_tpu_torch.distributed import coordination  # noqa: E402
from adanet_tpu_torch.ensemble import ComplexityRegularizedEnsembler  # noqa: E402
from adanet_tpu_torch.subnetwork.generator import SimpleGenerator  # noqa: E402

from torch_port_common import dnn_builder  # noqa: E402

GLOBAL_ROWS = 16


def full_batches():
    """The deterministic global batches (16 rows each) of spmd_runner.py."""
    rng = np.random.RandomState(7)
    batches = []
    for _ in range(4):
        x = rng.randn(GLOBAL_ROWS, 4).astype(np.float32)
        y = (x @ np.ones((4, 1), np.float32)) + 0.1
        batches.append(({"x": x}, y))
    return batches


def local_input_fn(rank, world):
    """This process's contiguous slice of every global batch."""
    rows = GLOBAL_ROWS // world
    lo, hi = rank * rows, (rank + 1) * rows

    def input_fn():
        for features, labels in full_batches():
            yield {"x": features["x"][lo:hi]}, labels[lo:hi]

    return input_fn


def search(model_dir, input_fn, device, cls=Estimator):
    """spmd_runner.py's search: two DNNs with reports, an Evaluator and a
    ReportMaterializer (2 batches), SGD 0.05 mixture weights combined
    through K1 (its plain version on the CPU), 2 x 6 steps."""
    return cls(
        head=RegressionHead(),
        subnetwork_generator=SimpleGenerator(
            [dnn_builder("a", 1, with_report=True), dnn_builder("b", 2, with_report=True)]
        ),
        max_iteration_steps=6,
        ensemblers=[ComplexityRegularizedEnsembler(optimizer=lambda p: torch.optim.SGD(p, lr=0.05),
                                                   use_fused_combine=True)],
        evaluator=Evaluator(input_fn=input_fn),
        report_materializer=ReportMaterializer(input_fn=input_fn, steps=2),
        max_iterations=2,
        model_dir=model_dir,
        log_every_steps=0,
        device=device,
    )


def probing(probes):
    """An Estimator class that records each winner's new members'
    parameters (`t<t>/<member>/<name>`) as it freezes them."""

    class ProbeEstimator(Estimator):
        def _complete_iteration(self, iteration, state, *args, **kwargs):
            frozen = super()._complete_iteration(iteration, state, *args, **kwargs)
            for ws in frozen.weighted_subnetworks:
                sub = ws.subnetwork
                for key, value in sub.module.state_dict().items():
                    probes["t%d/%s/%s" % (frozen.iteration_number, sub.name, key)] = value.detach().cpu().numpy()
            return frozen

    return ProbeEstimator


def oracle_probes(model_dir, device="cpu"):
    """The same search in one process on the whole batches."""
    probes = {}
    est = search(model_dir, lambda: iter(full_batches()), device, probing(probes))
    est.train(lambda: iter(full_batches()), max_steps=100)
    return probes


def run_spmd(model_dir, rank, world, device):
    from adanet_tpu_torch import ops

    ops.reset_launch_counts()
    probes = {}
    input_fn = local_input_fn(rank, world)
    est = search(model_dir, input_fn, device, probing(probes))
    est.train(input_fn, max_steps=100)
    assert est.latest_iteration_number() == 2, est.latest_iteration_number()
    if rank == 0:
        # The chief wrote the reports that the collective pass computed.
        reports = est._report_accessor.read_iteration_reports()
        assert len(reports) == 2 and reports[0], reports
    np.savez(os.path.join(model_dir, "probe_%d.npz" % rank), **probes)
    print("SPMD ROLE %d DONE launches %s" % (rank, json.dumps(ops.launch_counts())), flush=True)


def bagged_batches():
    """The bagged candidate's own global stream (a different resample),
    tests/spmd_bagging_runner.py's."""
    rng = np.random.RandomState(23)
    batches = []
    for _ in range(4):
        x = rng.randn(GLOBAL_ROWS, 4).astype(np.float32)
        y = (x @ np.full((4, 1), 0.5, np.float32)) - 0.2
        batches.append(({"x": x}, y))
    return batches


def shared_batches():
    """tests/spmd_bagging_runner.py's shared global batches."""
    rng = np.random.RandomState(11)
    batches = []
    for _ in range(4):
        x = rng.randn(GLOBAL_ROWS, 4).astype(np.float32)
        y = (x @ np.ones((4, 1), np.float32)) + 0.1
        batches.append(({"x": x}, y))
    return batches


def bagging_probes(model_dir, shared_fn, bagged_fn, device):
    """Trains the bagging search; returns both candidates' trained
    parameters at the iteration's end (`<candidate>/<name>`)."""
    from torch import nn

    from adanet_tpu_torch.autoensemble import AutoEnsembleEstimator, AutoEnsembleSubestimator

    class Linear(nn.Module):
        def __init__(self):
            super().__init__()
            self.dense = nn.Linear(4, 1)

        def forward(self, features, training=False):
            return self.dense(features["x"].float())

    class MLP(nn.Module):
        def __init__(self):
            super().__init__()
            self.hidden, self.logits = nn.Linear(4, 8), nn.Linear(8, 1)

        def forward(self, features, training=False):
            return self.logits(torch.relu(self.hidden(features["x"].float())))

    probes = {}

    class Probing(AutoEnsembleEstimator):
        def _complete_iteration(self, iteration, state, *args, **kwargs):
            for name, st in state.subnetworks.items():
                for key, value in st.module.state_dict().items():
                    probes["%s/%s" % (name, key)] = value.detach().cpu().numpy()
            return super()._complete_iteration(iteration, state, *args, **kwargs)

    def sgd(params):
        return torch.optim.SGD(params, lr=0.05)

    torch.manual_seed(0)
    est = Probing(
        head=RegressionHead(),
        candidate_pool={
            "bagged": AutoEnsembleSubestimator(MLP(), optimizer=sgd, train_input_fn=bagged_fn),
            "plain": AutoEnsembleSubestimator(Linear(), optimizer=sgd),
        },
        max_iteration_steps=6,
        ensemblers=[ComplexityRegularizedEnsembler(optimizer=sgd)],
        max_iterations=1,
        model_dir=model_dir,
        log_every_steps=0,
        device=device,
    )
    est.train(shared_fn, max_steps=6)
    assert est.latest_iteration_number() == 1, est.latest_iteration_number()
    return probes


def run_bagging(model_dir, rank, world, device):
    rows = GLOBAL_ROWS // world
    lo, hi = rank * rows, (rank + 1) * rows

    def local(batches):
        def input_fn():
            for features, labels in batches():
                yield {"x": features["x"][lo:hi]}, labels[lo:hi]

        return input_fn

    probes = bagging_probes(model_dir, local(shared_batches), local(bagged_batches), device)
    np.savez(os.path.join(model_dir, "bagging_%d.npz" % rank), **probes)
    print("BAGGING ROLE %d DONE" % rank, flush=True)


def run_sigterm(model_dir, rank, world, device):
    steps = [0]

    class Counting(Estimator):
        def _build_iteration(self, iteration_number, sample_batch):
            iteration = super()._build_iteration(iteration_number, sample_batch)
            step = iteration.train_step

            def counted(*args, **kwargs):
                out = step(*args, **kwargs)
                steps[0] += 1
                if steps[0] == 20:
                    print("TRAINING", flush=True)
                return out

            iteration.train_step = counted
            return iteration

    def input_fn():
        rng = np.random.RandomState(rank)
        while True:
            x = rng.randn(8, 4).astype(np.float32)
            yield {"x": x}, x.sum(axis=1, keepdims=True)

    est = Counting(
        head=RegressionHead(),
        subnetwork_generator=SimpleGenerator([dnn_builder("a", 1)]),
        max_iteration_steps=10**6,
        ensemblers=[ComplexityRegularizedEnsembler(optimizer=lambda p: torch.optim.SGD(p, lr=0.01))],
        max_iterations=1,
        model_dir=model_dir,
        log_every_steps=0,
        device=device,
    )
    est.train(input_fn)
    print("STOPPED AT %d" % steps[0], flush=True)


def run_lockstep(mode, rank):
    from adanet_tpu_torch.core.iteration import IterationBuilder
    from adanet_tpu_torch.ensemble import GrowStrategy

    rng = np.random.RandomState(5)
    x = rng.randn(8, 3).astype(np.float32)
    y = rng.randn(8, 1).astype(np.float32)

    def make_batch(n):
        return {"x": x[:n]}, y[:n]

    def input_fn():
        yield make_batch(8)
        yield make_batch(4) if mode == "shape" and rank == 1 else make_batch(8)
        if mode == "count" and rank == 0:
            yield make_batch(8)

    iteration = IterationBuilder(
        RegressionHead(), [ComplexityRegularizedEnsembler()], [GrowStrategy()], device="cpu"
    ).build_iteration(0, [dnn_builder("d", 1)], input_shape=(3,))
    iteration.set_process_group(torch.distributed.group.WORLD)
    state = iteration.init_state(torch.Generator().manual_seed(0), make_batch(8))
    try:
        scores = Evaluator(input_fn=input_fn).evaluate(iteration, state, collective=True)
    except ValueError as exc:
        assert "diverged" in str(exc), str(exc)
        assert mode in ("count", "shape"), (mode, str(exc))
        print("LOCKSTEP %s ROLE %d RAISED" % (mode, rank), flush=True)
        return
    assert mode == "ok", "guard failed to fire in mode %r" % mode
    assert np.isfinite(scores).all(), scores
    print("LOCKSTEP %s ROLE %d OK" % (mode, rank), flush=True)


def main(argv):
    mode, model_dir, rank, port, world = argv[0], argv[1], int(argv[2]), argv[3], int(argv[4])
    device = argv[5] if len(argv) > 5 else "cpu"
    backend = argv[6] if len(argv) > 6 else None
    assert GLOBAL_ROWS % world == 0, "world=%d must divide the 16-row global batches" % world
    torch.set_num_threads(1)
    coordination.initialize("localhost:%s" % port, world, rank, device=device, backend=backend)
    try:
        if mode == "spmd":
            run_spmd(model_dir, rank, world, device)
        elif mode == "bagging":
            run_bagging(model_dir, rank, world, device)
        elif mode == "sigterm":
            run_sigterm(model_dir, rank, world, device)
        elif mode.startswith("lockstep-"):
            run_lockstep(mode.split("-", 1)[1], rank)
        else:
            raise ValueError("unknown mode %r" % mode)
    finally:
        coordination.shutdown()


if __name__ == "__main__":
    main(sys.argv[1:])
