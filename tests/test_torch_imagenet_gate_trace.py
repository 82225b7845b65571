"""The ImageNet gate's RoundRobin iteration, step by step, in both packages
(ROADMAP C2: the port's slow gate reads 0.359-1.0 across threads and
seeds, JAX's 0.8438-1.0).

Settings: tests/test_torch_placement.py::test_imagenet_autoensemble_
convergence_gate's iteration (image 32, ResNet-18 width 8 +
EfficientNet-B0 under RoundRobin, batch 32, resnet_lr 0.05, the
`SyntheticProvider` with data seed 11), built by each package's trainer,
with two changes, both in both packages: EfficientNet's stochastic depth
(its drop-connect, the only draw on this path; the families have no other
dropout) at rate 0, so that neither framework draws; and both families in
f32 rather than bf16, so that the comparison sees the packages and not
two libraries' bf16 convolution orders. The JAX side runs in a process of
its own with one XLA intra-op thread (tests/torch_imagenet_gate_trace_
runner.py): it initialises the iteration, and the port starts from those
variables, converted (`utils.convert.convert_resnet`,
`convert_efficientnet`), over the same first STEPS batches, on one torch
thread.

After each step the test compares every batch-norm layer's running mean
(its gap relative to the norm of the layer's running standard deviation)
and variance (relative to its own norm), the subnetworks' train-mode
losses, the ensemble group's eval-mode losses (`adanet_loss/<candidate>`)
and the mixture weights, at a relative tolerance of TOL = 1e-4.

JAX against itself sets what rounding alone does: the runner trains the
same iteration again with each batch's rows in another order, which is
the same arithmetic rounded in another order. The test asserts every
quantity at step 1, and at each later step every quantity that rounding
alone has not yet moved past TOL / 10 in JAX; it prints the rest. The
ResNet's eval-mode ensemble loss is chaotic: rounding alone moves JAX's by
1e-2 to 1 of itself within five to eight steps, and the port's gap from
JAX tracks that move step by step (ROADMAP C2).
"""

import dataclasses
import functools
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

from torch_port_common import one_torch_thread

_one_torch_thread = pytest.fixture(autouse=True)(one_torch_thread)

HERE = os.path.dirname(os.path.abspath(__file__))
STEPS = 5
TOL = 1e-4


def _tree(flat, prefix):
    out = {}
    for key, value in flat.items():
        if not key.startswith(prefix):
            continue
        parts = key[len(prefix):].split("/")
        node = out
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return out


def _convert(name, flat, prefix):
    """A JAX AutoEnsemble subnetwork's variables (under `inner`) -> the
    port family's `state_dict` (numpy)."""
    from adanet_tpu_torch.utils.convert import convert_efficientnet, convert_resnet

    variables = {collection: tree["inner"] for collection, tree in _tree(flat, prefix).items()}
    convert = convert_resnet if name.startswith("resnet") else convert_efficientnet
    return {key: value.numpy() for key, value in convert(variables).items()}


def _jax_trace(out_dir):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1")
    proc = subprocess.run([sys.executable, os.path.join(HERE, "torch_imagenet_gate_trace_runner.py"), out_dir,
                           str(STEPS)], env=env, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0 and "TRACE OK" in proc.stdout, proc.stderr[-4000:]
    trace = np.load(os.path.join(out_dir, "trace.npz"))
    runs = {}
    for run in ("base", "permuted"):
        records = []
        for step in range(STEPS):
            head = "%s|%d|" % (run, step)
            record = {}
            for key in trace.files:
                if key.startswith(head + "metric|"):
                    record["metric|" + key.split("|")[-1]] = float(trace[key])
                elif key.startswith(head + "weights|"):
                    record["weights|" + key.split("|")[-1]] = trace[key]
            for name in ("resnet18", "efficientnet_b0"):
                for key, value in _convert(name, dict(trace), head + name + "|").items():
                    record["bn|%s|%s" % (name, key)] = value
            records.append(record)
        runs[run] = records
    return runs


def _port_trace(out_dir):
    from imagenet_gate_spread import DATA, GATE

    from adanet_tpu_torch.distributed.executor import RoundRobinExecutor
    from adanet_tpu_torch.models.efficientnet import EfficientNet
    from adanet_tpu_torch.models.resnet import ResNet
    from adanet_tpu_torch.research.imagenet_autoensemble import trainer
    from adanet_tpu_torch.research.imagenet_autoensemble.imagenet_data import SyntheticProvider

    data = np.load(os.path.join(out_dir, "batches.npz"))
    batches = [({"image": data["image_%d" % i]}, data["label_%d" % i]) for i in range(STEPS)]
    initial = dict(np.load(os.path.join(out_dir, "initial.npz")))
    pool_fn = trainer.candidate_pool

    def pool(*args, **kwargs):
        return {
            name: dataclasses.replace(sub, initial_variables={
                key: torch.from_numpy(value) for key, value in _convert(name, initial, name + "|").items()})
            for name, sub in pool_fn(*args, **kwargs).items()
        }

    patches = dict(ResNet=functools.partial(ResNet, compute_dtype=torch.float32),
                   EfficientNet=functools.partial(EfficientNet, compute_dtype=torch.float32, drop_path_rate=0.0),
                   candidate_pool=pool)
    saved = {name: getattr(trainer, name) for name in patches}
    try:
        for name, value in patches.items():
            setattr(trainer, name, value)
        flags = trainer.parse_args(["--dataset=fake", "--device=cpu", "--seed=42"]
                                   + ["--%s=%s" % item for item in GATE.items()])
        with tempfile.TemporaryDirectory() as model_dir:
            est = trainer.build_estimator(flags, SyntheticProvider(**DATA), model_dir)
            iteration = est._build_iteration(0, batches[0])
    finally:
        for name, value in saved.items():
            setattr(trainer, name, value)
    executor = RoundRobinExecutor(iteration, est._placement_strategy)
    state = executor.init_state(torch.Generator().manual_seed(0), batches[0])
    records = []
    for batch in batches:
        state, metrics = executor.train_step(state, batch)
        record = {"metric|" + key: float(value) for key, value in metrics.items()}
        for name, ensemble in state.ensembles.items():
            record["weights|" + name] = np.array([float(w.detach()) for w in ensemble.params["weights"]])
        for name, sub in state.subnetworks.items():
            for key, value in sub.module.state_dict().items():
                if key.endswith((".mean", ".var")):
                    record["bn|%s|%s" % (name, key[len("inner."):])] = value.detach().numpy().copy()
        records.append(record)
    return records


def _gaps(got, want):
    """Relative gaps by quantity: the worst batch-norm layer of each
    subnetwork, each loss, the worst mixture weight."""
    out = {}
    for key, value in want.items():
        if key.startswith("bn|"):
            scale = np.sqrt(want[key[:-len(".mean")] + ".var"]) if key.endswith(".mean") else value
            name = "bn/" + key.split("|")[1]
            out[name] = max(out.get(name, 0.0), float(np.linalg.norm(got[key] - value) / np.linalg.norm(scale)))
        elif key.startswith("weights|"):
            out["weights"] = max(out.get("weights", 0.0), float(np.max(np.abs(got[key] - value) / np.abs(value))))
        elif "adanet_loss" in key or "subnetwork_loss" in key:
            out[key.split("|")[1]] = abs(got[key] - value) / abs(value)
    return out


def test_imagenet_gate_round_robin_steps_match_jax(tmp_path):
    jax_runs = _jax_trace(str(tmp_path))
    port = _port_trace(str(tmp_path))
    asserted, rows = 0, []
    for step in range(STEPS):
        ours = _gaps(port[step], jax_runs["base"][step])
        rounding = _gaps(jax_runs["permuted"][step], jax_runs["base"][step])
        assert sorted(ours) == sorted(rounding) and len(ours) == 7, sorted(ours)
        for key in sorted(ours):
            rows.append("step %d %-66s port-JAX %.2e  JAX-JAX(rows permuted) %.2e" % (
                step + 1, key, ours[key], rounding[key]))
            if step == 0 or rounding[key] <= TOL / 10:
                assert ours[key] <= TOL, rows[-1]
                asserted += 1
    print("\n".join(rows))
    assert asserted >= 7 + 2 * (STEPS - 1)
