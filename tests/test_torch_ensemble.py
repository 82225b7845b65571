"""The port's ensembler, head and batcher helpers against the JAX package.

`ComplexityRegularizedEnsembler.build_ensemble` for SCALAR and VECTOR
weights (fused through K1's plain version on the CPU, and unfused) and
MATRIX weights (2-D and 3-D last layers), with and without bias, with the
complexity term; multi-head (dict) logits with a weight and a bias per
key, init and combine, and their complexity summed over the keys;
`mixture_weight_initializer`; that dict logits never reach K1's wrapper
(its entry stubbed); `MultiClassHead.predictions`; and the batcher's
`bucket_for` / `pad_batch` / `split_rows`. Inputs come from numpy seeds.

Tolerances: f32 logits and complexity atol 1e-6 (elementwise products and
short sums); MATRIX logits atol 1e-5 (a D-term f32 dot product in another
order; both sides run full f32, JAX at Precision.HIGHEST); probabilities
atol 1e-6; class ids equal.
"""

import zlib

import jax
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


KEYS = {"digit": 10, "even": 1, "value": 1}


def _multi_head_members(rng):
    return [
        dict(
            last_layer={k: rng.randn(B, D).astype(np.float32) for k in KEYS},
            logits={k: rng.randn(B, dim).astype(np.float32) for k, dim in KEYS.items()},
            complexity=float(j + 1),
        )
        for j in range(N)
    ]


def _jax_tree(x):
    if isinstance(x, dict):
        return {k: _jax_tree(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_jax_tree(v) for v in x]
    return jnp.asarray(x) if isinstance(x, np.ndarray) else x


def _torch_tree(x):
    if isinstance(x, dict):
        return {k: _torch_tree(v) for k, v in x.items()}
    return torch.from_numpy(x) if isinstance(x, np.ndarray) else x


@pytest.mark.parametrize("kind,use_bias,fused", [
    ("scalar", False, True), ("scalar", True, True), ("vector", True, False), ("matrix", True, False),
])
def test_multi_head_logits(kind, use_bias, fused):
    """Dict logits: init (1/N or zeros per key; bias per key), combine and
    complexity (summed over keys) against the JAX ensembler, fused or
    not (dict logits never fuse, in either package)."""
    rng = np.random.RandomState(zlib.crc32(repr(("multi", kind, use_bias)).encode()))
    members = _multi_head_members(rng)
    kwargs = dict(mixture_weight_type=kind, adanet_lambda=0.01, adanet_beta=0.002, use_bias=use_bias,
                  use_fused_combine=fused)
    jax_members = [JaxSubnetwork(**_jax_tree(m)) for m in members]
    torch_members = [Subnetwork(**_torch_tree(m)) for m in members]
    want_init = JaxEnsembler(**kwargs).init_ensemble(jax.random.PRNGKey(0), jax_members)
    got_init = ComplexityRegularizedEnsembler(**kwargs).init_ensemble(torch.Generator(), torch_members)
    assert sorted(got_init) == sorted(want_init)
    for g, w in zip(got_init["weights"], want_init["weights"]):
        assert sorted(g) == sorted(w) == sorted(KEYS)
        for key in KEYS:
            np.testing.assert_array_equal(g[key].numpy(), np.asarray(w[key]))
    if use_bias:
        for key in KEYS:
            np.testing.assert_array_equal(got_init["bias"][key].numpy(), np.asarray(want_init["bias"][key]))
    # Random weights and bias, carried across by convert_ensembler_params.
    shape = {"scalar": lambda k: (), "vector": lambda k: (KEYS[k],), "matrix": lambda k: (D, KEYS[k])}[kind]
    params = {"weights": [{k: np.asarray(rng.randn(*shape(k)), np.float32) for k in KEYS} for _ in range(N)]}
    if use_bias:
        params["bias"] = {k: rng.randn(KEYS[k]).astype(np.float32) for k in KEYS}
    want = JaxEnsembler(**kwargs).build_ensemble(_jax_tree(params), jax_members)
    got = ComplexityRegularizedEnsembler(**kwargs).build_ensemble(convert.convert_ensembler_params(params),
                                                                  torch_members)
    atol = 1e-5 if kind == "matrix" else 1e-6
    assert sorted(got.logits) == sorted(want.logits) == sorted(KEYS)
    for key in KEYS:
        np.testing.assert_allclose(got.logits[key].numpy(), np.asarray(want.logits[key]), atol=atol, rtol=0)
        np.testing.assert_allclose(got.weighted_subnetworks[0].logits[key].numpy(),
                                   np.asarray(want.weighted_subnetworks[0].logits[key]), atol=atol, rtol=0)
    np.testing.assert_allclose(float(got.complexity_regularization), float(want.complexity_regularization),
                               atol=1e-6, rtol=0)


def test_dict_logits_never_launch_k1(monkeypatch):
    """With `use_fused_combine`, single-head logits go through K1's
    wrapper (stubbed here to count its calls) and dict logits never do,
    as the JAX `_can_fuse` rule says."""
    from adanet_tpu_torch.ensemble import weighted

    calls = []
    real = weighted.fused_weighted_combine_members

    def stub(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(weighted, "fused_weighted_combine_members", stub)
    rng = np.random.RandomState(5)
    ensembler = ComplexityRegularizedEnsembler(use_fused_combine=True, use_bias=True)
    multi = [Subnetwork(**_torch_tree(m)) for m in _multi_head_members(rng)]
    params = ensembler.init_ensemble(torch.Generator(), multi)
    out = ensembler.build_ensemble(params, multi)
    assert not calls and sorted(out.logits) == sorted(KEYS)
    single = [Subnetwork(**{k: (torch.from_numpy(v) if k != "complexity" else v) for k, v in m.items()})
              for m in _members(rng, (B, D))]
    ensembler.build_ensemble(ensembler.init_ensemble(torch.Generator(), single), single)
    assert len(calls) == 1


def test_mixture_weight_initializer():
    """`mixture_weight_initializer(generator, shape, dtype)` replaces the
    1/N init, per member and per key, drawing in member order from the
    generator `init_ensemble` gets; a deterministic initializer gives the
    JAX ensembler's values."""
    rng = np.random.RandomState(6)
    single = [Subnetwork(**{k: (torch.from_numpy(v) if k != "complexity" else v) for k, v in m.items()})
              for m in _members(rng, (B, D))]
    seen = []

    def init(generator, shape, dtype):
        seen.append(tuple(shape))
        return torch.randn(shape, generator=generator, dtype=dtype)

    params = ComplexityRegularizedEnsembler(mixture_weight_type="vector", mixture_weight_initializer=init
                                            ).init_ensemble(torch.Generator().manual_seed(3), single)
    generator = torch.Generator().manual_seed(3)
    want = [torch.randn((C,), generator=generator) for _ in range(N)]
    assert seen == [(C,)] * N
    for j in range(N):
        assert torch.equal(params["weights"][j], want[j])
    multi = _multi_head_members(rng)
    got = ComplexityRegularizedEnsembler(mixture_weight_initializer=lambda g, shape, dtype: torch.full(
        shape, 0.25, dtype=dtype)).init_ensemble(torch.Generator(), [Subnetwork(**_torch_tree(m)) for m in multi])
    expect = JaxEnsembler(mixture_weight_initializer=lambda r, shape, dtype: jnp.full(shape, 0.25, dtype)
                          ).init_ensemble(jax.random.PRNGKey(0), [JaxSubnetwork(**_jax_tree(m)) for m in multi])
    for g, w in zip(got["weights"], expect["weights"]):
        for key in KEYS:
            np.testing.assert_array_equal(g[key].numpy(), np.asarray(w[key]))
