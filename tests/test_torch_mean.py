"""The port's `MeanEnsembler` against the JAX package's.

The mean of the members' logits, and with
`add_mean_last_layer_predictions` of their last layers, for tensor and
dict (multi-head) outputs, 1 to 3 members, on numpy-seeded inputs; no
parameters, no optimizer; the spec a serving generation records.
Tolerance: atol 1e-6 (f32 means of at most three values).
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adanet_tpu.ensemble import MeanEnsembler as JaxMean
from adanet_tpu.subnetwork import Subnetwork as JaxSubnetwork

from adanet_tpu_torch.ensemble import ensembler_from_spec
from adanet_tpu_torch.ensemble.mean import MEAN_LAST_LAYER, MeanEnsemble, MeanEnsembler
from adanet_tpu_torch.subnetwork.generator import Subnetwork

from torch_port_common import one_torch_thread

_one_torch_thread = pytest.fixture(autouse=True)(one_torch_thread)


def _member(rng, multi_head):
    if multi_head:
        return dict(last_layer={"a": rng.randn(6, 8).astype(np.float32), "b": rng.randn(6, 4).astype(np.float32)},
                    logits={"a": rng.randn(6, 10).astype(np.float32), "b": rng.randn(6, 1).astype(np.float32)})
    return dict(last_layer=rng.randn(6, 8).astype(np.float32), logits=rng.randn(6, 10).astype(np.float32))


def _tree(x, fn):
    return {k: _tree(v, fn) for k, v in x.items()} if isinstance(x, dict) else fn(x)


def _close(got, want):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for key in want:
            _close(got[key], want[key])
        return
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


@pytest.mark.parametrize("multi_head", [False, True])
@pytest.mark.parametrize("n", [1, 2, 3])
@pytest.mark.parametrize("last_layer", [False, True])
def test_mean_logits_and_last_layer_match_jax(n, multi_head, last_layer):
    rng = np.random.RandomState(zlib.crc32(repr((n, multi_head, last_layer)).encode()))
    members = [_member(rng, multi_head) for _ in range(n)]
    want = JaxMean(add_mean_last_layer_predictions=last_layer).build_ensemble(
        {}, [JaxSubnetwork(**{k: _tree(v, jnp.asarray) for k, v in m.items()}) for m in members])
    ensembler = MeanEnsembler(add_mean_last_layer_predictions=last_layer)
    subnetworks = [Subnetwork(**{k: _tree(v, torch.from_numpy) for k, v in m.items()}) for m in members]
    assert ensembler.init_ensemble(torch.Generator(), subnetworks) == JaxMean().init_ensemble(
        jax.random.PRNGKey(0), None) == {}
    got = ensembler.build_ensemble({}, subnetworks)
    assert isinstance(got, MeanEnsemble) and len(got.subnetworks) == n
    _close(got.logits, want.logits)
    if last_layer:
        _close(got.predictions[MEAN_LAST_LAYER], want.predictions[MEAN_LAST_LAYER])
    else:
        assert got.predictions is None and want.predictions is None


def test_mean_has_no_optimizer_and_round_trips_its_spec():
    ensembler = MeanEnsembler(name="avg", add_mean_last_layer_predictions=True)
    assert ensembler.build_train_optimizer() is None and JaxMean().build_train_optimizer() is None
    assert MeanEnsembler().name == JaxMean().name == "mean"
    rebuilt = ensembler_from_spec(ensembler.to_spec())
    assert isinstance(rebuilt, MeanEnsembler) and rebuilt.to_spec() == ensembler.to_spec()
    assert rebuilt.name == "avg"
