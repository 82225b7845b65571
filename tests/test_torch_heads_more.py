"""The port's regression, binary, multi-label and multi-head heads
against the JAX package's.

Copies of tests/test_heads.py's 11 tests (their own asserts kept), each
also holding every loss, metric and prediction of the port's head
against the JAX head on the same numpy inputs, without weights and with
per-example weights; the pairwise AUC oracle and the ties test for the
port's `_binary_auc`; random batches of every head with [B] and [B, 1]
labels and weights, with forced score ties; and each head's
`to_spec()` through `head_from_spec`.

Tolerances: atol 1e-6 (f32 cross-entropies, sigmoid cross-entropy in
optax's arithmetic, log_sigmoid in each framework's rounding; means over
at most 64 examples), AUC against the pairwise oracle rtol 1e-5 (the
oracle's sums run in f64); class ids and shapes equal.
"""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adanet_tpu.core import heads as jax_heads
from adanet_tpu_torch.core import heads

from torch_port_common import one_torch_thread

ATOL = 1e-6

_one_torch_thread = pytest.fixture(autouse=True)(one_torch_thread)


def _jax(x):
    if isinstance(x, dict):
        return {k: _jax(v) for k, v in x.items()}
    return None if x is None else jnp.asarray(x)


def _torch(x):
    if isinstance(x, dict):
        return {k: _torch(v) for k, v in x.items()}
    return None if x is None else torch.from_numpy(np.asarray(x))


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _close(got, want, what, atol=ATOL):
    assert sorted(got) == sorted(want), (what, sorted(got), sorted(want))
    for key in want:
        g, w = _np(got[key]), _np(want[key])
        assert g.shape == w.shape, (what, key, g.shape, w.shape)
        if np.issubdtype(w.dtype, np.integer) or w.dtype == bool:
            np.testing.assert_array_equal(g, w, err_msg="%s %s" % (what, key))
        else:
            np.testing.assert_allclose(g, w, atol=atol, rtol=0, err_msg="%s %s" % (what, key))


def _held(got_head, want_head, logits, labels, weights):
    """Loss and eval metrics of both heads without weights and with
    `weights`, and their predictions; returns the port's head."""
    for w in (None, weights):
        np.testing.assert_allclose(
            float(got_head.loss(_torch(logits), _torch(labels), _torch(w))),
            float(want_head.loss(_jax(logits), _jax(labels), _jax(w))),
            atol=ATOL, rtol=0,
        )
        _close(
            got_head.eval_metrics(_torch(logits), _torch(labels), _torch(w)),
            want_head.eval_metrics(_jax(logits), _jax(labels), _jax(w)),
            "eval_metrics(weights=%s)" % (w is not None),
        )
    _close(got_head.predictions(_torch(logits)), want_head.predictions(_jax(logits)), "predictions")
    return got_head


def _weights(n, seed, shape=None):
    return np.random.RandomState(seed).uniform(0.1, 2.0, size=shape or (n, 1)).astype(np.float32)


def test_regression_head():
    logits = np.asarray([[1.0], [2.0]], np.float32)
    labels = np.asarray([[0.0], [2.0]], np.float32)
    head = _held(heads.RegressionHead(), jax_heads.RegressionHead(), logits, labels, _weights(2, 0))
    np.testing.assert_allclose(float(head.loss(_torch(logits), _torch(labels))), 0.5)
    assert head.logits_dimension == 1
    np.testing.assert_allclose(head.predictions(_torch(logits))["predictions"].numpy(), logits)


def test_binary_head():
    logits = np.asarray([[10.0], [-10.0]], np.float32)
    labels = np.asarray([[1.0], [0.0]], np.float32)
    head = _held(heads.BinaryClassificationHead(), jax_heads.BinaryClassificationHead(), logits, labels,
                 _weights(2, 1))
    assert float(head.loss(_torch(logits), _torch(labels))) < 1e-3
    np.testing.assert_allclose(float(head.eval_metrics(_torch(logits), _torch(labels))["accuracy"]), 1.0)
    preds = head.predictions(_torch(logits))
    assert preds["class_ids"].tolist() == [[1], [0]]
    assert tuple(preds["probabilities"].shape) == (2, 2)


def test_multiclass_head():
    logits = np.asarray([[5.0, 0.0, 0.0], [0.0, 5.0, 0.0]], np.float32)
    labels = np.asarray([0, 1], np.int32)
    head = _held(heads.MultiClassHead(3), jax_heads.MultiClassHead(3), logits, labels, _weights(2, 2, (2,)))
    assert float(head.loss(_torch(logits), _torch(labels))) < 0.05
    np.testing.assert_allclose(float(head.eval_metrics(_torch(logits), _torch(labels))["accuracy"]), 1.0)
    assert head.predictions(_torch(logits))["class_ids"].tolist() == [0, 1]


def test_binary_head_rich_metrics():
    head, want_head = heads.BinaryClassificationHead(), jax_heads.BinaryClassificationHead()
    logits = np.asarray([[2.0], [-1.0], [1.0], [-2.0]], np.float32)
    labels = np.asarray([[1.0], [0.0], [0.0], [1.0]], np.float32)
    _held(head, want_head, logits, labels, _weights(4, 3))
    m = head.eval_metrics(_torch(logits), _torch(labels))
    # Pairs (pos, neg): (2,-1)W (2,1)W (-2,-1)L (-2,1)L -> AUC = 2/4.
    np.testing.assert_allclose(float(m["auc"]), 0.5)
    np.testing.assert_allclose(float(m["precision"]), 0.5)
    np.testing.assert_allclose(float(m["recall"]), 0.5)
    np.testing.assert_allclose(float(m["label/mean"]), 0.5)
    np.testing.assert_allclose(float(m["accuracy_baseline"]), 0.5)
    assert 0.0 < float(m["prediction/mean"]) < 1.0

    logits = np.asarray([[3.0], [2.0], [-2.0], [-3.0]], np.float32)
    labels = np.asarray([[1.0], [1.0], [0.0], [0.0]], np.float32)
    _held(head, want_head, logits, labels, _weights(4, 4))
    m = head.eval_metrics(_torch(logits), _torch(labels))
    for key in ("auc", "precision", "recall"):
        np.testing.assert_allclose(float(m[key]), 1.0)

    # A single-class batch: AUC is chance, the zero-denominator metrics 0.
    logits = np.asarray([[-1.0], [-2.0]], np.float32)
    labels = np.asarray([[0.0], [0.0]], np.float32)
    _held(head, want_head, logits, labels, _weights(2, 5))
    m = head.eval_metrics(_torch(logits), _torch(labels))
    np.testing.assert_allclose(float(m["auc"]), 0.5)
    np.testing.assert_allclose(float(m["precision"]), 0.0)
    np.testing.assert_allclose(float(m["recall"]), 0.0)


def test_binary_auc_handles_ties():
    p, y = np.full((4,), 0.7, np.float32), np.asarray([1, 0, 1, 0.0], np.float32)
    got = float(heads._binary_auc(_torch(p), _torch(y)))
    np.testing.assert_allclose(got, 0.5)
    np.testing.assert_allclose(got, float(jax_heads._binary_auc(_jax(p), _jax(y))), atol=ATOL, rtol=0)


def _pairwise(p, y, w):
    num = den = 0.0
    for i in range(len(p)):
        for j in range(len(p)):
            if y[i] > 0.5 and y[j] <= 0.5:
                pair_w = float(w[i]) * float(w[j])
                den += pair_w
                if p[i] > p[j]:
                    num += pair_w
                elif p[i] == p[j]:
                    num += 0.5 * pair_w
    return num / den


def test_binary_auc_matches_pairwise_oracle():
    rng = np.random.RandomState(0)
    p = rng.choice([0.1, 0.3, 0.3, 0.7, 0.9], size=64).astype(np.float32)
    y = rng.randint(0, 2, size=64).astype(np.float32)
    w = rng.uniform(0.0, 2.0, size=64).astype(np.float32)
    for weights in (None, w):
        got = float(heads._binary_auc(_torch(p), _torch(y), _torch(weights)))
        oracle = _pairwise(p, y, np.ones_like(w) if weights is None else w)
        np.testing.assert_allclose(got, oracle, rtol=1e-5)
        want = float(jax_heads._binary_auc(_jax(p), _jax(y), _jax(weights)))
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_binary_metrics_respect_weights():
    head, want_head = heads.BinaryClassificationHead(), jax_heads.BinaryClassificationHead()
    logits = np.asarray([[2.0], [-1.0], [5.0], [-5.0]], np.float32)
    labels = np.asarray([[1.0], [0.0], [0.0], [1.0]], np.float32)
    weights = np.asarray([[1.0], [1.0], [0.0], [0.0]], np.float32)
    _held(head, want_head, logits, labels, weights)
    m = head.eval_metrics(_torch(logits), _torch(labels), _torch(weights))
    sub = head.eval_metrics(_torch(logits[:2]), _torch(labels[:2]))
    for key in ("accuracy", "auc", "precision", "recall", "label/mean"):
        np.testing.assert_allclose(float(m[key]), float(sub[key]), rtol=1e-6)


def test_multiclass_top_k_accuracy():
    logits = np.zeros((2, 10), np.float32)
    logits[0, :5] = [5, 4, 3, 2, 1]
    logits[1, :6] = [6, 5, 4, 3, 2, 1]
    labels = np.asarray([4, 9], np.int32)
    head = _held(heads.MultiClassHead(10), jax_heads.MultiClassHead(10), logits, labels, _weights(2, 6, (2,)))
    m = head.eval_metrics(_torch(logits), _torch(labels))
    np.testing.assert_allclose(float(m["accuracy"]), 0.0)
    np.testing.assert_allclose(float(m["top_5_accuracy"]), 0.5)
    assert "top_5_accuracy" not in heads.MultiClassHead(3).eval_metrics(torch.zeros((1, 3)), torch.tensor([0]))
    m = heads.MultiClassHead(4, top_k=2).eval_metrics(torch.tensor([[1.0, 2.0, 3.0, 4.0]]), torch.tensor([2]))
    np.testing.assert_allclose(float(m["top_2_accuracy"]), 1.0)
    m = heads.MultiClassHead(4, top_k=4).eval_metrics(torch.tensor([[4.0, 3.0, 2.0, 1.0]]), torch.tensor([3]))
    np.testing.assert_allclose(float(m["top_4_accuracy"]), 1.0)
    with pytest.raises(ValueError):
        heads.MultiClassHead(4, top_k=5)


def test_multiclass_head_requires_two_classes():
    with pytest.raises(ValueError):
        heads.MultiClassHead(n_classes=1)
    with pytest.raises(ValueError):
        heads.MultiLabelHead(n_classes=1)


def test_multi_head():
    head = heads.MultiHead([heads.RegressionHead(name="reg"), heads.MultiClassHead(3, name="cls")],
                           head_weights=[1.0, 2.0])
    want_head = jax_heads.MultiHead([jax_heads.RegressionHead(name="reg"), jax_heads.MultiClassHead(3, name="cls")],
                                    head_weights=[1.0, 2.0])
    logits = {"reg": np.asarray([[1.0]], np.float32), "cls": np.asarray([[5.0, 0.0, 0.0]], np.float32)}
    labels = {"reg": np.asarray([[1.0]], np.float32), "cls": np.asarray([0], np.int32)}
    # Dict weights: one head weighted, the other without an entry.
    _held(head, want_head, logits, labels, {"cls": np.asarray([0.5], np.float32)})
    assert head.logits_dimension == {"reg": 1, "cls": 3}
    loss = float(head.loss(_torch(logits), _torch(labels)))
    cls_loss = float(heads.MultiClassHead(3).loss(_torch(logits["cls"]), _torch(labels["cls"])))
    np.testing.assert_allclose(loss, 2.0 * cls_loss, rtol=1e-5)
    assert "cls/accuracy" in head.eval_metrics(_torch(logits), _torch(labels))
    assert "reg/predictions" in head.predictions(_torch(logits))


def test_multilabel_head():
    logits = np.asarray([[10.0, -10.0, 10.0], [-10.0, 10.0, -10.0]], np.float32)
    labels = np.asarray([[1, 0, 1], [0, 1, 0]], np.float32)
    head = _held(heads.MultiLabelHead(3), jax_heads.MultiLabelHead(3), logits, labels, _weights(2, 7))
    assert head.logits_dimension == 3
    assert float(head.loss(_torch(logits), _torch(labels))) < 1e-3
    np.testing.assert_allclose(float(head.eval_metrics(_torch(logits), _torch(labels))["accuracy"]), 1.0)
    assert head.predictions(_torch(logits))["class_ids"].tolist() == [[1, 0, 1], [0, 1, 0]]
    with pytest.raises(ValueError):
        head.loss(torch.zeros((2, 4)), _torch(labels))


def _random_case(kind, b, seed, label_shape, ties):
    rng = np.random.RandomState(seed)
    dim = {"regression": 1, "binary": 1, "multilabel": 4, "multiclass": 5}[kind]
    logits = (rng.randn(b, dim) * 2.0).astype(np.float32)
    if ties:
        logits = np.round(logits).astype(np.float32)
    if kind == "multiclass":
        labels = rng.randint(0, dim, size=(b,)).astype(np.int32)
    elif kind == "regression":
        labels = rng.randn(b, 1).astype(np.float32)
    else:
        labels = (rng.rand(b, dim) > 0.5).astype(np.float32)
    if label_shape == "[B]" and dim == 1:
        labels = labels.reshape(b)
    weights = rng.uniform(0.0, 2.0, size=(b,) if label_shape == "[B]" else (b, 1)).astype(np.float32)
    return logits, labels, weights


_HEADS = {
    "regression": (heads.RegressionHead, jax_heads.RegressionHead, {}),
    "binary": (heads.BinaryClassificationHead, jax_heads.BinaryClassificationHead, {}),
    "multilabel": (heads.MultiLabelHead, jax_heads.MultiLabelHead, {"n_classes": 4}),
    "multiclass": (heads.MultiClassHead, jax_heads.MultiClassHead, {"n_classes": 5}),
}


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("label_shape", ["[B]", "[B, 1]"])
@pytest.mark.parametrize("kind", sorted(_HEADS))
def test_random_batches_match_jax(kind, label_shape, ties):
    logits, labels, weights = _random_case(kind, 64, zlib.crc32(repr((kind, label_shape, ties)).encode()), label_shape, ties)
    got_cls, want_cls, kwargs = _HEADS[kind]
    _held(got_cls(**kwargs), want_cls(**kwargs), logits, labels, weights)


def test_multi_head_of_every_head_matches_jax():
    rng = np.random.RandomState(11)
    parts = {name: _random_case(kind, 32, rng.randint(2**31), "[B, 1]", False) for name, kind in
             (("digit", "multiclass"), ("even", "binary"), ("value", "regression"), ("bits", "multilabel"))}

    def make(module):
        return module.MultiHead(
            [module.MultiClassHead(5, name="digit"), module.BinaryClassificationHead(name="even"),
             module.RegressionHead(name="value"), module.MultiLabelHead(4, name="bits")],
            head_weights=[1.0, 0.5, 2.0, 1.0],
        )

    got_head, want_head = make(heads), make(jax_heads)
    logits = {k: v[0] for k, v in parts.items()}
    labels = {k: v[1] for k, v in parts.items()}
    weights = {k: v[2] for k, v in parts.items() if k != "value"}
    _held(got_head, want_head, logits, labels, weights)


@pytest.mark.parametrize("head", [
    heads.RegressionHead(label_dimension=3, name="r"),
    heads.BinaryClassificationHead(name="b"),
    heads.MultiClassHead(7, name="c", top_k=2),
    heads.MultiLabelHead(4, name="m"),
    heads.MultiHead([heads.RegressionHead(name="r"), heads.MultiLabelHead(3, name="m")], head_weights=[0.5, 2.0],
                    name="mh"),
], ids=["regression", "binary", "multiclass", "multilabel", "multi_head"])
def test_spec_round_trip(head):
    rebuilt = heads.head_from_spec(head.to_spec())
    assert type(rebuilt) is type(head)
    assert rebuilt.to_spec() == head.to_spec()
    assert rebuilt.logits_dimension == head.logits_dimension and rebuilt.name == head.name
    with pytest.raises(ValueError, match="unknown head type"):
        heads.head_from_spec({"type": "nope"})
