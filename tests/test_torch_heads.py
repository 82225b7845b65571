"""The port's `MultiClassHead` against the JAX package's.

Loss, eval metrics (accuracy, average loss, top-k accuracy) and
predictions on fixed logits, labels and weights drawn from numpy seeds:
without weights and with [B] and [B, 1] weights, with top_k at its
default and set, with tied logits (top-k counts ties optimistically in
both), and for a head with too few classes for a default top-k. atol
1e-6 (f32 softmax cross-entropy and means over 32 examples).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adanet_tpu.core import heads as jax_heads
from adanet_tpu_torch.core import heads

B = 32


def _case(n_classes, weights, ties, seed):
    rng = np.random.RandomState(seed)
    logits = rng.randn(B, n_classes).astype(np.float32) * 2.0
    if ties:
        logits = np.round(logits).astype(np.float32)
    labels = rng.randint(0, n_classes, size=(B,)).astype(np.int32)
    w = None
    if weights == "[B]":
        w = rng.uniform(0.0, 2.0, size=(B,)).astype(np.float32)
    elif weights == "[B, 1]":
        w = rng.uniform(0.0, 2.0, size=(B, 1)).astype(np.float32)
    return logits, labels, w


def _both(logits, labels, w):
    jax_args = (jnp.asarray(logits), jnp.asarray(labels), None if w is None else jnp.asarray(w))
    torch_args = (torch.from_numpy(logits), torch.from_numpy(labels), None if w is None else torch.from_numpy(w))
    return jax_args, torch_args


@pytest.mark.parametrize("n_classes,top_k", [(10, None), (10, 3), (10, 10), (10, 0), (3, None)])
@pytest.mark.parametrize("weights", [None, "[B]", "[B, 1]"])
@pytest.mark.parametrize("ties", [False, True])
def test_loss_and_eval_metrics_match_jax(n_classes, top_k, weights, ties):
    logits, labels, w = _case(n_classes, weights, ties, seed=n_classes * 7 + (top_k or 0) + 100 * ties)
    jax_args, torch_args = _both(logits, labels, w)
    want_head = jax_heads.MultiClassHead(n_classes, top_k=top_k)
    got_head = heads.MultiClassHead(n_classes, top_k=top_k)
    np.testing.assert_allclose(float(got_head.loss(*torch_args)), float(want_head.loss(*jax_args)), atol=1e-6, rtol=0)
    want = want_head.eval_metrics(*jax_args)
    got = got_head.eval_metrics(*torch_args)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(float(got[key]), float(want[key]), atol=1e-6, rtol=0, err_msg=key)


def test_predictions_and_labels_of_shape_b1_match_jax():
    logits, labels, _ = _case(10, None, False, seed=3)
    want_head, got_head = jax_heads.MultiClassHead(10), heads.MultiClassHead(10)
    want = want_head.predictions(jnp.asarray(logits))
    got = got_head.predictions(torch.from_numpy(logits))
    np.testing.assert_allclose(got["probabilities"].numpy(), np.asarray(want["probabilities"]), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(got["class_ids"].numpy(), np.asarray(want["class_ids"]))
    labels_b1 = labels[:, None]
    np.testing.assert_allclose(
        float(got_head.loss(torch.from_numpy(logits), torch.from_numpy(labels_b1))),
        float(want_head.loss(jnp.asarray(logits), jnp.asarray(labels_b1))), atol=1e-6, rtol=0,
    )


def test_invalid_arguments_raise_as_in_jax():
    for n_classes, top_k in ((1, None), (10, 11), (10, -1)):
        with pytest.raises(ValueError):
            jax_heads.MultiClassHead(n_classes, top_k=top_k)
        with pytest.raises(ValueError):
            heads.MultiClassHead(n_classes, top_k=top_k)
    wrong = np.zeros((4, 7), np.float32)
    labels = np.zeros((4,), np.int32)
    with pytest.raises(ValueError, match="last dimension 10"):
        jax_heads.MultiClassHead(10).loss(jnp.asarray(wrong), jnp.asarray(labels))
    with pytest.raises(ValueError, match="last dimension 10"):
        heads.MultiClassHead(10).loss(torch.from_numpy(wrong), torch.from_numpy(labels))


def test_spec_round_trip_keeps_top_k():
    head = heads.MultiClassHead(10, name="h", top_k=3)
    again = heads.head_from_spec(head.to_spec())
    assert again.to_spec() == head.to_spec() == {"type": "multiclass", "n_classes": 10, "name": "h", "top_k": 3}


def test_weighted_mean_and_broadcast_match_jax():
    rng = np.random.RandomState(0)
    values = rng.randn(6, 3).astype(np.float32)
    for w in (rng.rand(6).astype(np.float32), rng.rand(6, 1).astype(np.float32), np.zeros(6, np.float32)):
        np.testing.assert_allclose(
            float(heads._weighted_mean(torch.from_numpy(values[:, 0]), torch.from_numpy(w))),
            float(jax_heads._weighted_mean(jnp.asarray(values[:, 0]), jnp.asarray(w))), atol=1e-6, rtol=0,
        )
        np.testing.assert_array_equal(
            heads._broadcast_weights(torch.from_numpy(w.reshape(6)), torch.from_numpy(values)).numpy(),
            np.asarray(jax_heads._broadcast_weights(jnp.asarray(w.reshape(6)), jnp.asarray(values))),
        )
    assert heads._broadcast_weights(None, torch.from_numpy(values)) is None
