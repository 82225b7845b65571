"""Multi-host RoundRobin runner for the port: one OS process a rank.

    python tests/torch_multihost_rr_runner.py search MODEL_DIR RANK WORLD PORT [DEVICE [BACKEND]]
    python tests/torch_multihost_rr_runner.py imagenet MODEL_DIR RANK WORLD PORT [DEVICE [BACKEND]]

The port's copy of tests/multihost_rr_runner.py. The processes join one
process group and train under `RoundRobinStrategy`, so the Estimator
builds `MultiHostRoundRobinExecutor`; every process feeds IDENTICAL
full batches, so each subnetwork trains as in one process.

- `search`: tests/multihost_rr_runner.py's search (DNNs "a" and "b", 2 x
  6 steps, SGD 0.05 mixture weights through K1). The chief writes
  `probe_0.npz` with each frozen winner's new members' parameters; every
  process writes `topology_<rank>.json` (the ownership map).
- `imagenet`: the ImageNet AutoEnsemble trainer's `build_estimator` at
  its defaults (ResNet-50 width 64 + EfficientNet-B0, 224 x 224, batch
  64, fake data), `--placement=round_robin`, 2 x 5 steps. Each process
  writes `imagenet_<rank>.json`: the subnetwork training losses it saw
  at each step, host-clock and CUDA-event ms a step, the member syncs'
  count, bytes and seconds, its launch counts (zeroed just before
  `train`, read just after) and peak memory; the chief also evaluates
  (`MHRR_STEPS` and `MHRR_ITERATIONS` set the steps, `MHRR_FLAGS` adds
  trainer flags: a smaller size on the CPU).

Every process prints `MHRR ROLE <rank> DONE`.
"""

import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from adanet_tpu_torch.core.estimator import Estimator  # noqa: E402
from adanet_tpu_torch.core.heads import RegressionHead  # noqa: E402
from adanet_tpu_torch.distributed import coordination, multihost  # noqa: E402
from adanet_tpu_torch.distributed.placement import RoundRobinStrategy  # noqa: E402
from adanet_tpu_torch.ensemble import ComplexityRegularizedEnsembler  # noqa: E402
from adanet_tpu_torch.subnetwork.generator import SimpleGenerator  # noqa: E402

from torch_port_common import dnn_builder  # noqa: E402


def full_batches():
    """tests/multihost_rr_runner.py's deterministic 16-row batches."""
    rng = np.random.RandomState(11)
    batches = []
    for _ in range(4):
        x = rng.randn(16, 4).astype(np.float32)
        y = (x @ np.ones((4, 1), np.float32)) + 0.1
        batches.append(({"x": x}, y))
    return batches


def search(model_dir, device, cls=Estimator, placement=True):
    return cls(
        head=RegressionHead(),
        subnetwork_generator=SimpleGenerator([dnn_builder("a", 1), dnn_builder("b", 2)]),
        max_iteration_steps=6,
        ensemblers=[ComplexityRegularizedEnsembler(optimizer=lambda p: torch.optim.SGD(p, lr=0.05),
                                                   use_fused_combine=True)],
        max_iterations=2,
        model_dir=model_dir,
        log_every_steps=0,
        device=device,
        placement_strategy=RoundRobinStrategy([torch.device(device)]) if placement else None,
    )


def probing(probes):
    """An Estimator class recording each frozen winner's new members'
    parameters (`t<t>/<member>/<name>`)."""

    class ProbeEstimator(Estimator):
        def _complete_iteration(self, iteration, state, *args, **kwargs):
            frozen = super()._complete_iteration(iteration, state, *args, **kwargs)
            for ws in frozen.weighted_subnetworks:
                sub = ws.subnetwork
                if sub.iteration_number == frozen.iteration_number:
                    for key, value in sub.module.state_dict().items():
                        probes["t%d/%s/%s" % (frozen.iteration_number, sub.name, key)] = (
                            value.detach().cpu().numpy())
            return frozen

    return ProbeEstimator


def run_search(model_dir, rank, world, device):
    groups, owners = multihost.multihost_candidate_groups(3, [torch.device(device)])
    probes = {}
    est = search(model_dir, device, probing(probes))
    est.train(lambda: iter(full_batches()), max_steps=100)
    assert est.latest_iteration_number() == 2, est.latest_iteration_number()
    if rank == 0:
        np.savez(os.path.join(model_dir, "probe_0.npz"), **probes)
    with open(os.path.join(model_dir, "topology_%d.json" % rank), "w") as f:
        json.dump({"owners": owners, "owned": [g for g in range(3) if groups[g]]}, f)


def run_imagenet(model_dir, rank, device):
    """The ImageNet trainer's search under multi-host RoundRobin, timed
    step by step at the executor; the chief also evaluates."""
    from adanet_tpu_torch import ops
    from adanet_tpu_torch.research.imagenet_autoensemble import trainer

    steps = int(os.environ.get("MHRR_STEPS", "10"))
    iterations = int(os.environ.get("MHRR_ITERATIONS", "2"))
    flags = trainer.parse_args(["--dataset=fake", "--boosting_iterations=%d" % iterations,
                                "--train_steps=%d" % steps, "--device=%s" % device, "--placement=round_robin"]
                               + os.environ.get("MHRR_FLAGS", "").split())
    cuda = torch.device(device).type == "cuda"
    marks, losses = [], []
    executors = []
    original = multihost.MultiHostRoundRobinExecutor.train_steps

    def timed(self, state, batches):
        out = original(self, state, batches)
        event = None
        if cuda:
            event = torch.cuda.Event(enable_timing=True)
            event.record()
        marks.append((self.iteration.iteration_number, time.perf_counter(), event))
        losses.append([self.iteration.iteration_number,
                       {k.split("/", 1)[1]: v for k, v in out[1].items() if k.startswith("subnetwork_loss/")}])
        if not executors or executors[-1] is not self:
            executors.append(self)
        return out

    multihost.MultiHostRoundRobinExecutor.train_steps = timed
    provider = trainer._provider(flags)
    est = trainer.build_estimator(flags, provider, os.path.join(model_dir, "mhrr"))
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    start = time.perf_counter()
    est.train(provider.get_input_fn("train"), max_steps=steps)
    if cuda:
        torch.cuda.synchronize()
    secs = time.perf_counter() - start
    launches = ops.launch_counts()
    # The last iteration's steps after its first (which pays the member
    # copies' first sync): ms a step by the host clock and CUDA events.
    last = [m for m in marks if m[0] == iterations - 1][1:]
    host_ms = (last[-1][1] - last[0][1]) / (len(last) - 1) * 1e3 if len(last) > 1 else None
    event_ms = last[0][2].elapsed_time(last[-1][2]) / (len(last) - 1) if cuda and len(last) > 1 else None
    syncs = {"syncs": 0, "bytes": 0, "secs": 0.0}
    for executor in executors:
        for key in syncs:
            syncs[key] += executor.sync_stats[key]
    record = dict(
        rank=rank, steps=len(marks), train_secs=secs, host_ms_per_step=host_ms, event_ms_per_step=event_ms,
        losses=[[t, {k: float(v) for k, v in step.items()}] for t, step in losses], syncs=syncs,
        launches=launches, max_memory_allocated_bytes=torch.cuda.max_memory_allocated() if cuda else None,
        iteration=est.latest_iteration_number(), global_step=est.latest_global_step(),
        peer_lost=est._peer_lost is not None, store_bytes_retained_peak=multihost.kv_bytes_retained_peak[0],
    )
    if rank == 0:
        ops.reset_launch_counts()
        metrics = est.evaluate(provider.get_input_fn("test"))
        record["metrics"] = {k: v for k, v in metrics.items() if isinstance(v, (int, float))}
        record["eval_launches"] = ops.launch_counts()
    with open(os.path.join(model_dir, "imagenet_%d.json" % rank), "w") as f:
        json.dump(record, f)


def main(argv):
    mode, model_dir, rank, world, port = argv[:5]
    rank, world = int(rank), int(world)
    device = argv[5] if len(argv) > 5 else "cpu"
    backend = argv[6] if len(argv) > 6 else None
    torch.set_num_threads(1)
    coordination.initialize("localhost:%s" % port, world, rank, device=device, backend=backend)
    if mode == "search":
        run_search(model_dir, rank, world, device)
    elif mode == "imagenet":
        run_imagenet(model_dir, rank, device)
    else:
        raise ValueError("unknown mode %r" % mode)
    print("MHRR ROLE %d DONE" % rank, flush=True)
    coordination.leave()
    sys.stdout.flush()
    os._exit(0)


if __name__ == "__main__":
    main(sys.argv[1:])
