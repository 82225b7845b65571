"""The JAX package's NASNet training results, recorded for the port's tests.

On the CPU, the JAX package takes 27 s (f32) and 33 s (bf16) to compile
one jitted training forward and gradient of a 3-cell NASNet-A, and about
95 s to compile one `Iteration` step holding one, so the tier-1 tests
cannot run it. `record()` runs the JAX package on the inputs below and
returns its results; `python tests/torch_nasnet_golden.py` writes them to
`tests/data/torch_nasnet_golden.npz` (float32 arrays under "/"-joined
keys), with `inputs_digest()` of the inputs they were recorded on.
`tests/test_torch_nasnet_train.py` and `tests/test_torch_improve_nas.py`
hold the port against the file; tier-1 checks the digest, so inputs that
change without a new recording fail, and runs one smaller forward
(`LIVE`) through `jax_forward` live. `test_golden_file_is_current`
(RUN_SLOW) records again and holds the file against the fresh results.

The inputs are drawn in numpy from fixed seeds, in the port's layouts
(`torch_port_common.port_numpy_state` over the port module's
`state_dict`), and reach the JAX package through `flax_tree`:

- `forward` and `forward_b32`: one `NasNetA` training forward and its
  gradient, f32 and bf16, 3 cells, 4 filters, 10 x 10 x 3 images, batch
  4 (`forward`) and 32 (`forward_b32`: the aux head's two batch norms
  take their statistics over 32 values a channel there, 4 at batch 4),
  the auxiliary head on, drop-path keep 0.6 at progress 0.3 (schedule
  step 3 of 10),
  dense dropout keep 0.8, trained statistics (count 1). The loss is
  sum(logits * c1) + sum(aux_logits * c2) for fixed cotangents. The
  drop-path and dropout draws are numpy's, handed to both packages in the
  order the layers draw them (`jax.random.uniform` and
  `jax.random.bernoulli` are replaced while the JAX forward is traced).
- `trajectory`: an `Iteration` of each package with the improve_nas
  `Builder` (same net, drop-path and dropout off, f32, K2's path), the
  fused combine, sgd 0.05 on the mixture weights, adanet_lambda 0.01,
  momentum with a cosine schedule over 4 steps; 2 iterations x 4 steps
  on batches of 4. Iteration 0 is shared; iteration 1 runs once per
  distillation mode (NONE, ADAPTIVE, BORN_AGAIN) on it.
"""

import hashlib
import os
import sys
import zlib

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from adanet_tpu_torch.models import nasnet as torch_nasnet  # noqa: E402
from adanet_tpu_torch.research.improve_nas import improve_nas as torch_improve_nas  # noqa: E402

from torch_port_common import flatten, flax_tree, port_numpy_state  # noqa: E402

PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "torch_nasnet_golden.npz")

SHAPE = (10, 10, 3)
BATCH = 4
CLASSES = 10
NET = dict(num_classes=CLASSES, num_cells=3, num_conv_filters=4, use_pallas_sep_conv=True)
FORWARD = dict(NET, drop_path_keep_prob=0.6, dense_dropout_keep_prob=0.8, total_training_steps=10)
FORWARD_START_STEP = 3.0
#: The recorded forward cases: key prefix -> batch.
FORWARD_BATCHES = {"forward": BATCH, "forward_b32": 32}
#: The live case: 2 cells (a reduction, a cell, the aux head, a reduction
#: and a cell), f32, batch 4; about 14 s of JAX compile on the CPU.
LIVE = dict(FORWARD, num_cells=2)
DTYPES = ("float32", "bfloat16")
MODES = ("none", "adaptive", "born_again")
STEPS, ITERATIONS = 4, 2
TRAJECTORY_HPARAMS = dict(
    num_cells=3,
    num_conv_filters=4,
    drop_path_keep_prob=1.0,
    dense_dropout_keep_prob=1.0,
    use_aux_head=True,
    total_training_steps=100,
    use_pallas_sep_conv=True,
    initial_learning_rate=0.05,
)
MIXTURE_LR, ADANET_LAMBDA = 0.05, 0.01
COSINE_STEPS = 4


def forward_model(dtype_name, net=FORWARD):
    """The port's model of a forward case."""
    cfg = torch_nasnet.NasNetConfig(**net, compute_dtype=getattr(torch, dtype_name))
    return torch_nasnet.NasNetA(cfg, SHAPE)


def forward_inputs(batch=BATCH, net=FORWARD):
    """(images, logits cotangent, aux cotangent, port-layout variables)."""
    rng = np.random.RandomState(11)
    images = rng.randn(batch, *SHAPE).astype(np.float32)
    c1 = rng.randn(batch, CLASSES).astype(np.float32)
    c2 = rng.randn(batch, CLASSES).astype(np.float32)
    state = port_numpy_state(forward_model("float32", net).state_dict(), seed=12, trained_stats=True)
    state["step"] = np.asarray(FORWARD_START_STEP, np.float32)
    return images, c1, c2, state


class Draws:
    """numpy U[0, 1) draws in order, recorded, for both packages."""

    def __init__(self, seed=13):
        self._rng = np.random.RandomState(seed)
        self.values = []

    def __call__(self, shape):
        value = self._rng.uniform(size=shape).astype(np.float32)
        self.values.append(value)
        return value


def trajectory_batches():
    rng = np.random.RandomState(21)
    return [
        ({"image": rng.randn(BATCH, *SHAPE).astype(np.float32)}, rng.randint(0, CLASSES, BATCH).astype(np.int32))
        for _ in range(STEPS * ITERATIONS)
    ]


def trajectory_state(iteration):
    """Port-layout initial variables of the subnetwork of `iteration`."""
    builder = torch_improve_nas.Builder(None, torch_improve_nas.Hparams(**TRAJECTORY_HPARAMS, compute_dtype=torch.float32))
    module = builder.build_subnetwork(CLASSES, input_shape=SHAPE)
    return port_numpy_state(module.state_dict(), seed=zlib.crc32(b"trajectory/%d" % iteration))


def trajectory_row(metrics, ensembles, weight_of):
    """One step's record: every metric and every mixture weight."""
    row = {k: float(np.asarray(v)) for k, v in metrics.items()}
    for name, est in ensembles.items():
        for j, w in enumerate(est.params["weights"]):
            row["weight/%s/%d" % (name, j)] = float(weight_of(w))
    return row


# ------------------------------------------------------------------ the JAX side


def inputs_digest():
    """sha256 over every input the recording reads, as uint8."""
    digest = hashlib.sha256()
    arrays = []
    for batch in sorted(FORWARD_BATCHES.values()):
        images, c1, c2, state = forward_inputs(batch)
        arrays += [images, c1, c2] + [state[k] for k in sorted(state)]
    for features, labels in trajectory_batches():
        arrays += [features["image"], labels]
    for t in range(ITERATIONS):
        state = trajectory_state(t)
        arrays += [state[k] for k in sorted(state)]
    for a in arrays:
        digest.update(np.ascontiguousarray(a).tobytes())
    return np.frombuffer(digest.digest(), np.uint8)


def jax_forward(dtype_name, batch=BATCH, net=FORWARD):
    """The JAX package's training forward and gradient on a case's inputs
    (jitted), with the drop-path and dropout draws it used."""
    import jax
    import jax.numpy as jnp

    from adanet_tpu.models import nasnet as jax_nasnet

    images, c1, c2, state = forward_inputs(batch, net)
    variables = flax_tree(state)
    model = jax_nasnet.NasNetA(jax_nasnet.NasNetConfig(**net, compute_dtype=getattr(jnp, dtype_name)))
    draws = Draws()

    def loss(params):
        (logits, aux, pooled), mutated = model.apply(
            {**variables, "params": params}, images, training=True,
            rngs={"dropout": jax.random.PRNGKey(0)}, mutable=["batch_stats", "schedule"],
        )
        value = jnp.sum(logits * c1) + jnp.sum(aux * c2)
        return value, (logits, aux, pooled, mutated)

    uniform, bernoulli = jax.random.uniform, jax.random.bernoulli
    jax.random.uniform = lambda key, shape=(), dtype=jnp.float32, *a, **k: jnp.asarray(draws(shape))
    jax.random.bernoulli = lambda key, p=0.5, shape=None: jnp.asarray(draws(shape)) < p
    try:
        (value, (logits, aux, pooled, mutated)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            variables["params"]
        )
    finally:
        jax.random.uniform, jax.random.bernoulli = uniform, bernoulli
    out = {"value": value, "logits": logits, "aux_logits": aux, "pooled": pooled}
    out.update(flatten({"grad": grads}))
    out.update(flatten({"mutated": dict(mutated)}))
    out.update({"draws/%03d" % i: v for i, v in enumerate(draws.values)})
    return {k: np.asarray(jax.device_get(v), np.float32) for k, v in out.items()}


def _jax_trajectory():
    import jax
    import optax

    from adanet_tpu.core.heads import MultiClassHead
    from adanet_tpu.core.iteration import IterationBuilder
    from adanet_tpu.ensemble import ComplexityRegularizedEnsembler, GrowStrategy
    from research.improve_nas.trainer import improve_nas, optimizer

    factory = IterationBuilder(
        MultiClassHead(CLASSES),
        [ComplexityRegularizedEnsembler(optimizer=optax.sgd(MIXTURE_LR), adanet_lambda=ADANET_LAMBDA,
                                        use_fused_combine=True)],
        [GrowStrategy()],
    )
    optimizer_fn = optimizer.fn_with_name("momentum", "cosine", cosine_decay_steps=COSINE_STEPS)
    batches = trajectory_batches()

    def run(t, mode, previous):
        hparams = improve_nas.Hparams(**TRAJECTORY_HPARAMS, compute_dtype=np.float32,
                                      knowledge_distillation=improve_nas.KnowledgeDistillation(mode))
        builder = improve_nas.Builder(optimizer_fn, hparams, num_classes=CLASSES)
        builder.initial_variables = flax_tree(trajectory_state(t))
        iteration = factory.build_iteration(t, [builder], previous)
        state = iteration.init_state(jax.random.PRNGKey(t), batches[t * STEPS])
        rows = {}
        for s in range(STEPS):
            state, metrics = iteration.train_step(state, batches[t * STEPS + s])
            rows.update({"%d/%s" % (t * STEPS + s, k): v for k, v in trajectory_row(
                metrics, state.ensembles, np.asarray).items()})
        best = iteration.best_candidate_index(state)
        rows["best/%d" % t] = best
        frozen = iteration.freeze_candidate(state, iteration.ensemble_specs[best].name, batches[t * STEPS])
        sub = jax.device_get(state.subnetworks[builder.name].variables)
        rows.update(flatten({"final/%d" % t: {k: sub[k] for k in ("batch_stats", "schedule")}}))
        return rows, frozen

    out = {}
    first, frozen = run(0, "none", None)
    for mode in MODES:
        rows, _ = run(1, mode, frozen)
        out.update({"%s/%s" % (mode, k): v for k, v in {**first, **rows}.items()})
    return {k: np.asarray(v, np.float32) for k, v in out.items()}


def record():
    """{key: float32 array} of every JAX result the port's tests read,
    and `inputs_sha256`, the digest of the inputs (uint8)."""
    out = {"inputs_sha256": inputs_digest()}
    for prefix, batch in FORWARD_BATCHES.items():
        for dtype_name in DTYPES:
            out.update({"%s/%s/%s" % (prefix, dtype_name, k): v for k, v in jax_forward(dtype_name, batch).items()})
    out.update({"trajectory/%s" % k: v for k, v in _jax_trajectory().items()})
    return out


def load(prefix):
    """The recorded results under `prefix` + "/", keys without it."""
    with np.load(PATH) as data:
        return {k[len(prefix) + 1:]: data[k] for k in data.files if k.startswith(prefix + "/")}


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    results = record()
    os.makedirs(os.path.dirname(PATH), exist_ok=True)
    np.savez_compressed(PATH, **results)
    print("wrote %d arrays to %s" % (len(results), PATH))
