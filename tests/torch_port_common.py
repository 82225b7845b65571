"""Shared inputs of the port's parity tests (tests/test_torch_*.py).

Parameters are drawn from a numpy seed into the JAX package's own
variable tree (its structure from `jax.eval_shape` of the module's
training-mode init, so the aux-head parameters exist), then handed to
both packages: the JAX module as is, the port through `utils.convert`.
Drawing them with numpy keeps the tests fast (an eager or jitted Flax
init of even a 3-cell NASNet takes tens of seconds on the CPU) and
makes the parameters independent of either framework's generator.
jax is imported inside the functions that use it, so that the tests that
run on the card, where jax is not installed, can use `require_cuda`.
"""

import functools

import numpy as np


def variable_shapes(module, sample):
    """The variable tree (`ShapeDtypeStruct` leaves) of a training-mode
    init of `module` on inputs like `sample`."""
    import jax

    return jax.eval_shape(
        functools.partial(module.init, training=True),
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        sample,
    )


def numpy_variables(shapes, seed, trained_stats=False):
    """Flax variables of the tree `shapes` (`variable_shapes`), as nested
    dicts of numpy arrays drawn from `seed`.

    Kernels ~ N(0, 1/fan_in); batch-norm scales ~ 1 + N(0, 0.1^2) and
    biases ~ N(0, 0.1^2); Dense biases ~ N(0, 0.1^2). With
    `trained_stats`, batch-norm statistics are random (mean ~ N(0,
    0.1^2), var ~ U(0.5, 1.5)) with count = 1, so the trained-statistics
    branch runs; otherwise they are the init values (count = 0).
    """
    import jax

    rng = np.random.RandomState(seed)

    def leaf(path, spec):
        collection = path[0].key
        name = path[-1].key
        shape = spec.shape
        if collection == "params":
            if name == "kernel":
                fan_in = int(np.prod(shape[:-1]))
                return (rng.randn(*shape) / np.sqrt(fan_in)).astype(np.float32)
            if name == "scale":
                return (1.0 + 0.1 * rng.randn(*shape)).astype(np.float32)
            return (0.1 * rng.randn(*shape)).astype(np.float32)
        if collection == "batch_stats" and trained_stats:
            if name == "mean":
                return (0.1 * rng.randn(*shape)).astype(np.float32)
            if name == "var":
                return rng.uniform(0.5, 1.5, shape).astype(np.float32)
            return np.ones(shape, np.float32)
        return np.zeros(shape, spec.dtype)

    return jax.tree_util.tree_map_with_path(leaf, dict(shapes))


def require_cuda():
    """Skips the calling test unless a CUDA card is present. Call it
    inside the test (marked `@pytest.mark.cuda`), never at import, so
    that every worker collects the same tests."""
    import pytest
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: python -m pytest --noconftest -m cuda tests/test_torch_card.py")


def one_torch_thread():
    """A fixture body: torch's CPU ops on one thread for the test, the
    previous count restored after. The search tests run many small ops,
    which parallel test workers (pytest -n) would otherwise run on every
    core each, to everyone's loss."""
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def port_numpy_state(state_dict, seed, trained_stats=False):
    """numpy values for every entry of a port module's `state_dict`, as
    `numpy_variables` draws them for the Flax tree (fan-in from the
    Flax kernel shape), in the port's layouts. `count` is 1 with
    `trained_stats` (statistics random), else 0; `step` is 0."""
    rng = np.random.RandomState(seed)
    out = {}
    for key, tensor in state_dict.items():
        shape = tuple(tensor.shape)
        name = key.rsplit(".", 1)[-1]
        if name == "weight":
            fan_in = int(np.prod(shape[1:]))
            value = rng.randn(*shape) / np.sqrt(fan_in)
        elif name == "scale":
            value = 1.0 + 0.1 * rng.randn(*shape)
        elif name == "bias":
            value = 0.1 * rng.randn(*shape)
        elif name == "mean" and trained_stats:
            value = 0.1 * rng.randn(*shape)
        elif name == "var" and trained_stats:
            value = rng.uniform(0.5, 1.5, shape)
        elif name == "count" and trained_stats:
            value = np.ones(shape)
        else:
            value = np.zeros(shape)
        out[key] = np.asarray(value, np.float32)
    return out


def flax_tree(state):
    """The Flax variable tree of a port state dict of numpy arrays: the
    inverse of `utils.convert.convert_variables` (`weight` -> `kernel`,
    OIHW -> HWIO, [out, in] -> [in, out]; `mean`/`var`/`count` into
    `batch_stats`, `step` into `schedule`, the rest into `params`)."""
    tree = {}
    for key, value in state.items():
        *path, name = key.split(".")
        collection = {"mean": "batch_stats", "var": "batch_stats", "count": "batch_stats",
                      "step": "schedule"}.get(name, "params")
        if name == "weight":
            name = "kernel"
            value = np.transpose(value, (2, 3, 1, 0)) if value.ndim == 4 else value.T
        node = tree.setdefault(collection, {})
        for part in path:
            node = node.setdefault(part, {})
        node[name] = np.array(value, order="C")
    return tree


def flatten(tree, prefix=""):
    """{"a/b/c": leaf} of a nested dict."""
    out = {}
    for key, value in tree.items():
        path = prefix + "/" + str(key) if prefix else str(key)
        if isinstance(value, dict):
            out.update(flatten(value, path))
        else:
            out[path] = value
    return out


def unflatten(flat):
    """The nested dict of `flatten`'s output."""
    tree = {}
    for path, value in flat.items():
        *parts, name = path.split("/")
        node = tree
        for part in parts:
            node = node.setdefault(part, {})
        node[name] = value
    return tree


def linear_dataset(n=64, dim=2, batch_size=16, seed=42, classification=False):
    """tests/helpers.py's toy dataset (numpy only): an input_fn of
    ({"x": [batch, dim]}, [batch, 1]) batches."""
    rng = np.random.RandomState(seed)
    x = rng.randn(n, dim).astype(np.float32)
    w = np.linspace(1.0, 2.0, dim).astype(np.float32)
    y = x @ w[:, None] + 0.1 * rng.randn(n, 1).astype(np.float32)
    if classification:
        y = (y > 0).astype(np.float32)

    def input_fn():
        for start in range(0, n, batch_size):
            yield {"x": x[start:start + batch_size]}, y[start:start + batch_size]

    return input_fn


def dnn_builder(name, num_layers=1, learning_rate=0.1, hidden=8, nan_logits=False, with_report=False):
    """The port's counterpart of tests/helpers.py's `DNNBuilder`: `hidden`
    wide relu layers named `dense_<i>`, then `logits` (`logits_<head>`
    for dict logits dimensions), SGD at `learning_rate`; with
    `with_report`, a report with a `mean_logit` metric. Its parameters
    are initialised from the engine's generator (LeCun-normal kernels,
    zero biases, as Flax's Dense)."""
    import math
    from collections.abc import Mapping

    import torch
    from torch import nn

    from adanet_tpu_torch.subnetwork.generator import Builder, Subnetwork
    from adanet_tpu_torch.subnetwork.report import Report

    class _DNN(nn.Module):
        def __init__(self, input_dim, logits_dimension):
            super().__init__()
            width = input_dim
            for i in range(num_layers):
                setattr(self, "dense_%d" % i, nn.Linear(width, hidden))
                width = hidden
            self.heads = sorted(logits_dimension) if isinstance(logits_dimension, Mapping) else None
            if self.heads is None:
                self.logits = nn.Linear(width, logits_dimension)
            else:
                for key in self.heads:
                    setattr(self, "logits_%s" % key, nn.Linear(width, logits_dimension[key]))

        def init_parameters(self, generator):
            with torch.no_grad():
                for layer in self.children():
                    std = math.sqrt(1.0 / layer.in_features) / 0.87962566103423978
                    nn.init.trunc_normal_(layer.weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
                    layer.bias.zero_()

        def forward(self, features, training=False):
            x = features["x"] if isinstance(features, Mapping) else features
            x = x.to(torch.float32)
            for i in range(num_layers):
                x = torch.relu(getattr(self, "dense_%d" % i)(x))
            if self.heads is None:
                logits = self.logits(x)
            else:
                logits = {key: getattr(self, "logits_%s" % key)(x) for key in self.heads}
            if nan_logits:
                logits = logits * float("nan")
            return Subnetwork(
                last_layer=x if self.heads is None else {key: x for key in self.heads},
                logits=logits,
                complexity=float(np.sqrt(max(num_layers, 1))),
                shared={"num_layers": num_layers},
            )

    class _Builder(Builder):
        @property
        def name(self):
            return name

        def build_subnetwork(self, logits_dimension, previous_ensemble=None, *, input_shape):
            return _DNN(int(np.prod(input_shape)), logits_dimension)

        def build_train_optimizer(self, previous_ensemble=None):
            return lambda named: torch.optim.SGD([p for _, p in named], lr=learning_rate)

        def build_subnetwork_report(self):
            if not with_report:
                return None
            return Report(
                hparams={"num_layers": num_layers},
                attributes={"name": name},
                metrics={"mean_logit": lambda subnetwork, features, labels: torch.mean(subnetwork.logits)},
            )

    return _Builder()
