"""The JAX side of tests/test_torch_imagenet_gate_trace.py, in a process of
its own (so that XLA's CPU backend starts with the caller's `XLA_FLAGS`,
one intra-op thread).

    python tests/torch_imagenet_gate_trace_runner.py OUT_DIR STEPS

Builds the ImageNet gate's RoundRobin iteration t = 0 through the JAX
trainer (tests/imagenet_gate_spread.py's flags: image 32, ResNet-18 width
8 + EfficientNet-B0, batch 32, resnet_lr 0.05, SyntheticProvider seed 11)
with both families in f32 and EfficientNet's stochastic depth at rate 0,
initialises it from PRNGKey(0), and trains STEPS steps on the provider's
first batches twice from the same initial variables: on the batches as
they come, and with each batch's rows in another order (numpy seed 5),
which is the same arithmetic rounded in another order (JAX against
itself: how far rounding alone moves the run). Writes to OUT_DIR:

- `batches.npz`: the batches (`image_<i>`, `label_<i>`);
- `initial.npz`: each subnetwork's initial variables, keys
  `<subnetwork>|<collection>/<path>`;
- `trace.npz`: for each run (`base`, `permuted`) and step, every subnetwork's
  batch-norm statistics (`<run>|<step>|<subnetwork>|batch_stats/<path>`)
  and the step's metrics and mixture weights (`<run>|<step>|metric|<key>`,
  `<run>|<step>|weights|<ensemble>`).
"""

import functools
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

from imagenet_gate_spread import DATA, GATE  # noqa: E402


def _flat(tree, prefix=""):
    if isinstance(tree, dict) or hasattr(tree, "items"):
        out = {}
        for key, value in tree.items():
            out.update(_flat(value, "%s%s/" % (prefix, key)))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def main(out_dir, steps):
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    from absl import flags

    from adanet_tpu.distributed.executor import RoundRobinExecutor
    from adanet_tpu.models.efficientnet import EfficientNet
    from adanet_tpu.models.resnet import ResNet
    from research.imagenet_autoensemble import trainer
    from research.imagenet_autoensemble.imagenet_data import SyntheticProvider

    flags.FLAGS(["trainer"])
    for key, value in dict(GATE, dataset="fake", seed=42).items():
        setattr(flags.FLAGS, key, value)
    trainer.ResNet = functools.partial(ResNet, compute_dtype=jnp.float32)
    trainer.EfficientNet = functools.partial(EfficientNet, compute_dtype=jnp.float32, drop_path_rate=0.0)
    provider = SyntheticProvider(**DATA)
    batches = []
    while len(batches) < steps:
        for batch in provider.get_input_fn("train")():
            batches.append(batch)
            if len(batches) == steps:
                break
    np.savez(os.path.join(out_dir, "batches.npz"),
             **{("image_%d" % i): b[0]["image"] for i, b in enumerate(batches)},
             **{("label_%d" % i): b[1] for i, b in enumerate(batches)})
    est = trainer.build_estimator(provider, os.path.join(out_dir, "model"))
    iteration = est._build_iteration(0, batches[0])
    executor = RoundRobinExecutor(iteration, est._placement_strategy)
    base = jax.device_get(iteration.init_state(jax.random.PRNGKey(0), batches[0]))
    np.savez(os.path.join(out_dir, "initial.npz"), **{
        "%s|%s" % (name, key): value
        for name, st in base.subnetworks.items() for key, value in _flat(st.variables).items()
    })
    record = {}
    # The same steps with each batch's rows in another order: the same
    # arithmetic, rounded in another order (batch norm's and the losses'
    # reductions).
    order = np.random.RandomState(5).permutation(DATA["batch_size"])
    permuted = [({"image": b[0]["image"][order]}, b[1][order]) for b in batches]
    for run, data in (("base", batches), ("permuted", permuted)):
        executor._host_step, executor._last_sync_step, executor._member_vars_cache = 0, 0, None
        state = executor.place(base)
        for step, batch in enumerate(data):
            state, metrics = executor.train_step(state, batch)
            host = executor.gather(state)
            for name, st in host.subnetworks.items():
                for key, value in _flat(st.variables.get("batch_stats", {}), "batch_stats/").items():
                    record["%s|%d|%s|%s" % (run, step, name, key)] = value
            for key, value in jax.device_get(metrics).items():
                record["%s|%d|metric|%s" % (run, step, key)] = np.asarray(value)
            for name, ens in host.ensembles.items():
                record["%s|%d|weights|%s" % (run, step, name)] = np.asarray(
                    [np.asarray(w) for w in ens.params["weights"]], np.float32)
    np.savez(os.path.join(out_dir, "trace.npz"), **record)
    print("TRACE OK %d" % steps, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], int(sys.argv[2])))
