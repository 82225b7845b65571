"""The ImageNet AutoEnsemble gate's spread, in either package, on the CPU.

    python tests/imagenet_gate_spread.py port --seed 42 --threads 1
    python tests/imagenet_gate_spread.py jax --seed 42

Runs tests/test_imagenet_pipeline.py's gate (its port copy is
tests/test_torch_placement.py::test_imagenet_autoensemble_convergence_gate):
image 32, ResNet-18 width 8 + EfficientNet-B0 under RoundRobin, 60 steps
of batch 32, resnet_lr 0.05, on 256 synthetic images from data seed 11,
with the trainer's `--seed` (the initial parameters) as given. `--threads`
sets torch's CPU threads for the port; for JAX, XLA's intra-op threads
follow `XLA_FLAGS` (for example `--xla_cpu_multi_thread_eigen=false
intra_op_parallelism_threads=1`). Prints one line, `RESULT {json}`: the
evaluation's scalar metrics and, for every training step, the
subnetworks' losses (train mode) and each candidate's adanet loss (the
ensemble update's, on eval-mode members under RoundRobin).
"""

import argparse
import json
import os
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

GATE = dict(image_size=32, placement="round_robin", resnet_depth=18, resnet_width=8, efficientnet_variant="b0",
            candidates="resnet50,efficientnet_b0", boosting_iterations=1, train_steps=60, batch_size=32,
            resnet_lr=0.05)
DATA = dict(num_classes=8, num_examples=256, batch_size=32, image_size=32, seed=11)


def _recorded(executor_cls, trace, to_host):
    """Wraps the RoundRobin executor's step entry points to append each
    call's losses to `trace`."""
    for name in ("train_step", "train_steps"):
        original = getattr(executor_cls, name)

        def wrapped(self, *args, _original=original, **kwargs):
            state, metrics = _original(self, *args, **kwargs)
            trace.append({k: np.asarray(to_host(v)).tolist() for k, v in metrics.items()
                          if k.startswith(("adanet_loss", "subnetwork_loss"))})
            return state, metrics

        setattr(executor_cls, name, wrapped)


def run_port(seed, threads, model_dir):
    import torch

    from adanet_tpu_torch.distributed.executor import RoundRobinExecutor
    from adanet_tpu_torch.research.imagenet_autoensemble import trainer
    from adanet_tpu_torch.research.imagenet_autoensemble.imagenet_data import SyntheticProvider

    torch.set_num_threads(threads)
    trace = []
    _recorded(RoundRobinExecutor, trace, lambda v: v.detach().cpu() if torch.is_tensor(v) else v)
    argv = ["--dataset=fake", "--device=cpu", "--seed=%d" % seed] + ["--%s=%s" % kv for kv in GATE.items()]
    provider = SyntheticProvider(**DATA)
    est = trainer.build_estimator(trainer.parse_args(argv), provider, model_dir)
    est.train(provider.get_input_fn("train"), max_steps=GATE["train_steps"])
    return est.evaluate(provider.get_input_fn("test")), trace


def run_jax(seed, model_dir):
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)
    from absl import flags

    from adanet_tpu.distributed.executor import RoundRobinExecutor
    from research.imagenet_autoensemble import trainer
    from research.imagenet_autoensemble.imagenet_data import SyntheticProvider

    flags.FLAGS(["trainer"])
    for key, value in dict(GATE, dataset="fake", seed=seed).items():
        setattr(flags.FLAGS, key, value)
    trace = []
    _recorded(RoundRobinExecutor, trace, jax.device_get)
    provider = SyntheticProvider(**DATA)
    est = trainer.build_estimator(provider, model_dir)
    est.train(provider.get_input_fn("train"), max_steps=GATE["train_steps"])
    return est.evaluate(provider.get_input_fn("test")), trace


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("package", choices=("port", "jax"))
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--threads", type=int, default=1)
    args = parser.parse_args(argv)
    with tempfile.TemporaryDirectory(prefix="imagenet_gate_") as model_dir:
        if args.package == "port":
            metrics, trace = run_port(args.seed, args.threads, model_dir)
        else:
            metrics, trace = run_jax(args.seed, model_dir)
    scalars = {k: (v if isinstance(v, str) else float(v)) for k, v in metrics.items() if np.ndim(v) == 0}
    print("RESULT " + json.dumps(dict(package=args.package, seed=args.seed, threads=args.threads, metrics=scalars,
                                      trace=trace)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
