"""The port's bf16 step policy (`utils/precision.py`) and `tree_where`
against the JAX package's, on the same numpy inputs.

- `cast_floats` / `cast_batch`: the same leaves are cast (wide floats
  only: f64 and f32 to bf16, f64 to f32), the same pass through (ints,
  bools, already-narrow floats, labels, preserved keys), with equal
  values (bf16 rounding is round-to-nearest-even in both: exact).
- `resolve_dtype`: names and dtypes resolve to the same type; a
  non-float target raises `ValueError` in both; None stays None.
- `tree_where` over a nested tree equals the JAX one, exactly.
- The step boundary: `IterationBuilder(step_compute_dtype="bfloat16")`
  hands the model bf16 features and f32 labels, while parameters,
  optimizer slots, losses and metrics stay f32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from adanet_tpu.utils import precision as jax_precision
from adanet_tpu.utils import trees as jax_trees

from adanet_tpu_torch.core.heads import MultiClassHead
from adanet_tpu_torch.core.iteration import IterationBuilder
from adanet_tpu_torch.ensemble.strategy import GrowStrategy
from adanet_tpu_torch.ensemble.weighted import ComplexityRegularizedEnsembler
from adanet_tpu_torch.subnetwork.generator import Builder, Subnetwork
from adanet_tpu_torch.utils import precision, trees

TORCH_OF = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32,
            "float64": torch.float64, "int32": torch.int32, "int64": torch.int64, "bool": torch.bool}


def _tree(rng):
    return {
        "f64": rng.randn(3, 2),
        "f32": rng.randn(4).astype(np.float32),
        "f16": rng.randn(2).astype(np.float16),
        "i32": rng.randint(0, 5, (3,)).astype(np.int32),
        "flag": np.array([True, False]),
        "nested": [rng.randn(2, 2).astype(np.float32), {"w": rng.rand(3).astype(np.float32)}],
    }


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for key in sorted(tree):
            out.update(_flat(tree[key], "%s/%s" % (prefix, key)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, item in enumerate(tree):
            out.update(_flat(item, "%s/%d" % (prefix, i)))
        return out
    return {prefix: tree}


def _same(got, want):
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        g = got[key]
        w = np.asarray(w)
        g_dtype = g.dtype if torch.is_tensor(g) else torch.from_numpy(np.asarray(g)).dtype
        assert g_dtype == TORCH_OF[str(w.dtype)], (key, g_dtype, w.dtype)
        g_np = g.float().numpy() if torch.is_tensor(g) and g.dtype == torch.bfloat16 else np.asarray(g)
        np.testing.assert_array_equal(g_np, w.astype(np.float32) if str(w.dtype) == "bfloat16" else w, err_msg=key)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_cast_floats_matches_jax(dtype):
    tree = _tree(np.random.RandomState(0))
    _same(precision.cast_floats(tree, dtype), jax_precision.cast_floats(tree, dtype))
    _same(precision.cast_floats(tree, dtype, preserve_keys=("f32",)),
          jax_precision.cast_floats(tree, dtype, preserve_keys=("f32",)))
    assert precision.cast_floats(tree, None) is tree


def test_cast_batch_keeps_labels_and_casts_tensors():
    rng = np.random.RandomState(1)
    features = {"x": rng.randn(4, 3).astype(np.float32), "w": rng.rand(4).astype(np.float32)}
    labels = rng.randn(4, 1).astype(np.float32)
    got = precision.cast_batch((features, labels), "bfloat16", preserve_keys=("w",))
    want = jax_precision.cast_batch((features, labels), "bfloat16", preserve_keys=("w",))
    _same(list(got), list(want))
    assert got[1] is labels
    tensors = precision.cast_batch((torch.from_numpy(features["x"]), torch.arange(4)), "bfloat16")
    assert tensors[0].dtype == torch.bfloat16 and tensors[1].dtype == torch.int64
    assert precision.cast_batch(features, "bfloat16")["x"].dtype == torch.bfloat16


@pytest.mark.parametrize("dtype", ["bfloat16", "float32", np.float32, jnp.bfloat16, torch.bfloat16, None])
def test_resolve_dtype_matches_jax(dtype):
    got = precision.resolve_dtype(dtype)
    want = jax_precision.resolve_dtype(None if dtype is torch.bfloat16 else dtype)
    if dtype is None:
        assert got is None and want is None
    elif dtype is torch.bfloat16:
        assert got is torch.bfloat16
    else:
        assert got == TORCH_OF[str(np.dtype(want))]


@pytest.mark.parametrize("dtype", ["int32", np.int64, torch.int32, "bool"])
def test_resolve_dtype_rejects_non_float(dtype):
    with pytest.raises(ValueError, match="floating"):
        precision.resolve_dtype(dtype)
    if not isinstance(dtype, torch.dtype):
        with pytest.raises(ValueError, match="floating"):
            jax_precision.resolve_dtype(dtype)
    with pytest.raises(ValueError, match="floating"):
        IterationBuilder(MultiClassHead(3), [ComplexityRegularizedEnsembler()], [GrowStrategy()], device="cpu",
                         step_compute_dtype=dtype)


def test_tree_where_matches_jax():
    rng = np.random.RandomState(2)
    a = {"p": [rng.randn(3).astype(np.float32), rng.randn(2, 2).astype(np.float32)], "q": rng.randn(1).astype(np.float32)}
    b = {"p": [rng.randn(3).astype(np.float32), rng.randn(2, 2).astype(np.float32)], "q": rng.randn(1).astype(np.float32)}
    a["p"][0][1] = np.nan
    for pred in (True, False):
        got = trees.tree_where(torch.tensor(pred), *[{"p": [torch.from_numpy(x) for x in t["p"]],
                                                      "q": torch.from_numpy(t["q"])} for t in (a, b)])
        want = jax_trees.tree_where(jnp.asarray(pred), a, b)
        got_flat, want_flat = _flat(got), _flat(want)
        for key in want_flat:
            np.testing.assert_array_equal(got_flat[key].numpy(), np.asarray(want_flat[key]), err_msg=key)


class _Probe(nn.Module):
    """Records the dtype of the features it sees."""

    def __init__(self, input_dim, classes, seen):
        super().__init__()
        self.dense = nn.Linear(input_dim, classes)
        self.seen = seen

    def forward(self, features, training=False):
        self.seen.append(features["x"].dtype)
        return Subnetwork(last_layer=features["x"], logits=self.dense(features["x"].float()), complexity=1.0)


class _ProbeBuilder(Builder):
    name = "probe"

    def __init__(self, seen):
        self.seen = seen

    def build_subnetwork(self, logits_dimension, previous_ensemble=None, *, input_shape):
        return _Probe(input_shape[0], logits_dimension, self.seen)

    def build_train_optimizer(self, previous_ensemble=None):
        return lambda named: torch.optim.Adam([p for _, p in named], lr=1e-2)


def test_step_boundary_casts_features_only():
    seen = []
    factory = IterationBuilder(MultiClassHead(3), [ComplexityRegularizedEnsembler(
        optimizer=lambda params: torch.optim.SGD(params, lr=0.1))], [GrowStrategy()], device="cpu",
        step_compute_dtype="bfloat16")
    rng = np.random.RandomState(3)
    batch = ({"x": rng.randn(8, 5).astype(np.float32)}, rng.randint(0, 3, (8,)).astype(np.int32))
    iteration = factory.build_iteration(0, [_ProbeBuilder(seen)], input_shape=(5,))
    assert iteration.step_compute_dtype is torch.bfloat16
    state = iteration.init_state(torch.Generator().manual_seed(0), batch)
    seen.clear()
    state, metrics = iteration.train_step(state, batch)
    assert seen == [torch.bfloat16]
    st = state.subnetworks["probe"]
    assert all(p.dtype == torch.float32 for p in st.module.parameters())
    assert all(v.dtype == torch.float32 for s in st.optimizer.state.values() for k, v in s.items() if k != "step")
    assert all(v.dtype == torch.float32 for v in metrics.values())
    assert int(st.step) == 1
