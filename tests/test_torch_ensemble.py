"""The port's ensembler, head and batcher helpers against the JAX package.

`ComplexityRegularizedEnsembler.build_ensemble` for SCALAR and VECTOR
weights (fused through K1's plain version on the CPU, and unfused) and
MATRIX weights (2-D and 3-D last layers), with and without bias, with the
complexity term; `MultiClassHead.predictions`; and the batcher's
`bucket_for` / `pad_batch` / `split_rows`. Inputs come from numpy seeds.

Tolerances: f32 logits and complexity atol 1e-6 (elementwise products and
short sums); MATRIX logits atol 1e-5 (a D-term f32 dot product in another
order; both sides run full f32, JAX at Precision.HIGHEST); probabilities
atol 1e-6; class ids equal.
"""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adanet_tpu.core.heads import MultiClassHead as JaxHead
from adanet_tpu.ensemble import ComplexityRegularizedEnsembler as JaxEnsembler
from adanet_tpu.serving import batcher as jax_batcher
from adanet_tpu.subnetwork import Subnetwork as JaxSubnetwork

from adanet_tpu_torch.core.heads import MultiClassHead, head_from_spec
from adanet_tpu_torch.ensemble.weighted import ComplexityRegularizedEnsembler
from adanet_tpu_torch.serving import batcher
from adanet_tpu_torch.subnetwork.generator import Subnetwork
from adanet_tpu_torch.utils import convert

B, C, D, N = 6, 10, 12, 3


def _members(rng, last_layer_shape):
    return [
        dict(
            last_layer=rng.randn(*last_layer_shape).astype(np.float32),
            logits=rng.randn(*(last_layer_shape[:-1] + (C,))).astype(np.float32),
            complexity=float(j + 1),
        )
        for j in range(N)
    ]


def _weights(rng, kind):
    shape = {"scalar": (), "vector": (C,), "matrix": (D, C)}[kind]
    return [np.asarray(rng.randn(*shape), np.float32) for _ in range(N)]


@pytest.mark.parametrize(
    "kind,fused,use_bias,rank",
    [
        ("scalar", True, False, 2),
        ("scalar", True, True, 2),
        ("scalar", False, True, 2),
        ("vector", True, True, 2),
        ("vector", False, False, 2),
        ("matrix", False, True, 2),
        ("matrix", False, False, 3),
    ],
)
def test_build_ensemble_matches_jax(kind, fused, use_bias, rank):
    rng = np.random.RandomState(zlib.crc32(repr((kind, fused, use_bias, rank)).encode()))
    shape = (B, D) if rank == 2 else (B, 4, D)
    members = _members(rng, shape)
    params = {"weights": _weights(rng, kind)}
    if use_bias:
        params["bias"] = rng.randn(C).astype(np.float32)
    kwargs = dict(
        mixture_weight_type=kind,
        adanet_lambda=0.01,
        adanet_beta=0.002,
        use_bias=use_bias,
        use_fused_combine=fused,
    )
    want = JaxEnsembler(**kwargs).build_ensemble(
        {k: (v if k == "bias" else [jnp.asarray(w) for w in v]) for k, v in params.items()},
        [JaxSubnetwork(**{k: (jnp.asarray(v) if k != "complexity" else v) for k, v in m.items()}) for m in members],
    )
    got = ComplexityRegularizedEnsembler(**kwargs).build_ensemble(
        convert.convert_ensembler_params(params),
        [Subnetwork(**{k: (torch.from_numpy(v) if k != "complexity" else v) for k, v in m.items()}) for m in members],
    )
    atol = 1e-5 if kind == "matrix" else 1e-6
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(want.logits), atol=atol, rtol=0)
    np.testing.assert_allclose(
        float(got.complexity_regularization), float(want.complexity_regularization), atol=1e-6, rtol=0
    )
    assert (got.weighted_subnetworks[0].logits is None) == (want.weighted_subnetworks[0].logits is None)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_bias", [False, True])
@pytest.mark.parametrize("kind", ["scalar", "vector"])
def test_fused_equals_unfused_and_jax(kind, use_bias, dtype):
    """The fused combine (K1 on the members' logits as they lie) against
    the port's unfused path and the JAX ensembler's fused path. bf16
    member logits are cast to f32 first on both fused paths; the unfused
    path gets the same f32 logits."""
    rng = np.random.RandomState(zlib.crc32(repr((kind, use_bias, dtype)).encode()))
    members = _members(rng, (B, D))
    params = {"weights": _weights(rng, kind)}
    if use_bias:
        params["bias"] = rng.randn(C).astype(np.float32)
    kwargs = dict(mixture_weight_type=kind, adanet_lambda=0.01, use_bias=use_bias)
    want = JaxEnsembler(use_fused_combine=True, **kwargs).build_ensemble(
        {k: (v if k == "bias" else [jnp.asarray(w) for w in v]) for k, v in params.items()},
        [
            JaxSubnetwork(
                last_layer=jnp.asarray(m["last_layer"]),
                logits=jnp.asarray(m["logits"], getattr(jnp, dtype)),
                complexity=m["complexity"],
            )
            for m in members
        ],
    )
    torch_params = convert.convert_ensembler_params(params)
    logits = [torch.from_numpy(m["logits"]).to(getattr(torch, dtype)) for m in members]

    def build(fused, member_logits):
        return ComplexityRegularizedEnsembler(use_fused_combine=fused, **kwargs).build_ensemble(
            torch_params,
            [
                Subnetwork(last_layer=torch.from_numpy(m["last_layer"]), logits=l, complexity=m["complexity"])
                for m, l in zip(members, member_logits)
            ],
        )

    fused = build(True, logits)
    unfused = build(False, [l.float() for l in logits])
    assert fused.logits.dtype == torch.float32
    np.testing.assert_allclose(fused.logits.numpy(), unfused.logits.numpy(), atol=1e-6, rtol=0)
    np.testing.assert_allclose(fused.logits.numpy(), np.asarray(want.logits), atol=1e-6, rtol=0)
    np.testing.assert_allclose(
        float(fused.complexity_regularization), float(want.complexity_regularization), atol=1e-6, rtol=0
    )


def test_fused_combine_prepares_weights_once_per_version():
    """A second `build_ensemble` with unchanged weights prepares nothing
    (the served call stacks nothing); an in-place change to one member's
    weight prepares again, and the result follows it."""
    from adanet_tpu_torch.ops import sepconv_kernels

    rng = np.random.RandomState(9)
    members = [Subnetwork(**{k: (torch.from_numpy(v) if k != "complexity" else v) for k, v in m.items()})
               for m in _members(rng, (B, D))]
    params = convert.convert_ensembler_params({"weights": _weights(rng, "vector")})
    ensembler = ComplexityRegularizedEnsembler(mixture_weight_type="vector", use_fused_combine=True)
    unfused = ComplexityRegularizedEnsembler(mixture_weight_type="vector")
    before = sepconv_kernels.prepare.made
    with torch.inference_mode():
        first = ensembler.build_ensemble(params, members).logits
    assert sepconv_kernels.prepare.made == before + 1
    with torch.inference_mode():
        second = ensembler.build_ensemble(params, members).logits
    assert sepconv_kernels.prepare.made == before + 1
    assert torch.equal(first, second)
    with torch.no_grad():
        params["weights"][1].mul_(-2.0)
    with torch.inference_mode():
        third = ensembler.build_ensemble(params, members).logits
        want = unfused.build_ensemble(params, members).logits
    assert sepconv_kernels.prepare.made == before + 2
    assert not torch.equal(third, first)
    np.testing.assert_allclose(third.numpy(), want.numpy(), atol=1e-6, rtol=0)


def test_multiclass_predictions_match_jax():
    logits = np.random.RandomState(0).randn(7, C).astype(np.float32)
    want = JaxHead(C).predictions(jnp.asarray(logits))
    head = head_from_spec(MultiClassHead(C).to_spec())
    got = head.predictions(torch.from_numpy(logits))
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(want["logits"]), atol=0, rtol=0)
    np.testing.assert_allclose(
        got["probabilities"].numpy(), np.asarray(want["probabilities"]), atol=1e-6, rtol=0
    )
    np.testing.assert_array_equal(got["class_ids"].numpy(), np.asarray(want["class_ids"]))
    assert got["class_ids"].dtype == torch.int32


def test_batcher_helpers_match_jax():
    rng = np.random.RandomState(1)
    requests = [{"image": rng.randn(n, 4, 4, 3).astype(np.float32)} for n in (1, 3, 8)]
    buckets = (1, 2, 4, 8, 16, 32)
    for rows in (1, 3, 12, 32):
        assert batcher.bucket_for(rows, buckets) == jax_batcher.bucket_for(rows, buckets)
    with pytest.raises(ValueError):
        batcher.bucket_for(33, buckets)
    got, got_rows = batcher.pad_batch(requests, 16)
    want, want_rows = jax_batcher.pad_batch(requests, 16)
    assert got_rows == want_rows == 12
    np.testing.assert_array_equal(got["image"], np.asarray(want["image"]))
    outputs = {"logits": torch.from_numpy(got["image"].reshape(16, -1))}
    split = batcher.split_rows(outputs, [1, 3, 8])
    want_split = jax_batcher.split_rows({"logits": got["image"].reshape(16, -1)}, [1, 3, 8])
    for a, b in zip(split, want_split):
        np.testing.assert_array_equal(a["logits"], np.asarray(b["logits"]))
