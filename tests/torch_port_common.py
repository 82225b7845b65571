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
