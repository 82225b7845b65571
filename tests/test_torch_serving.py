"""The port's serving slice end to end on the CPU, against the JAX package.

JAX side: two improve_nas NASNet-A members (3 cells, 8 filters, 16x16x3,
f32 compute, `use_pallas_sep_conv=True`) combined by a SCALAR
`ComplexityRegularizedEnsembler(use_fused_combine=True)` (the Pallas
combine, interpret mode off-TPU) and `MultiClassHead.predictions`, i.e.
`Estimator._frozen_predict_fn` without the estimator. Port side: the same
numpy-seeded parameters converted, published as `gen-1`, and served
through `ServingFrontend(Batcher(ModelPool(model_dir, device="cpu")))`
with requests of 1, 3 and 8 rows.

Tolerances (f32 compute): logits atol 1e-4 (as the NASNet parity test),
probabilities atol 1e-5, class_ids equal.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adanet_tpu.core.heads import MultiClassHead as JaxHead
from adanet_tpu.ensemble import ComplexityRegularizedEnsembler as JaxEnsembler
from adanet_tpu.ensemble import MixtureWeightType as JaxWeightType
from research.improve_nas.trainer import improve_nas as jax_improve_nas

from adanet_tpu_torch.core.architecture import Architecture
from adanet_tpu_torch.core.frozen import (
    FrozenEnsemble,
    FrozenSubnetwork,
    FrozenWeightedSubnetwork,
)
from adanet_tpu_torch.core.heads import MultiClassHead
from adanet_tpu_torch.ensemble.weighted import (
    ComplexityRegularizedEnsembler,
    MixtureWeightType,
)
from adanet_tpu_torch.research.improve_nas import improve_nas
from adanet_tpu_torch.serving import (
    Batcher,
    ModelPool,
    ServingFrontend,
    publish_generation,
)
from adanet_tpu_torch.robustness import integrity
from adanet_tpu_torch.utils import convert
from torch_port_common import numpy_variables, variable_shapes, one_torch_thread

_one_torch_thread = pytest.fixture(autouse=True)(one_torch_thread)

SHAPE = (16, 16, 3)
MIXTURE = [0.7, 0.45]
ROWS = (1, 3, 8)


@pytest.fixture(scope="module")
def reference():
    """Requests, member variables and the JAX predictions for each row."""
    rng = np.random.RandomState(5)
    requests = [rng.randn(n, *SHAPE).astype(np.float32) for n in ROWS]
    images = np.concatenate(requests)
    hp = jax_improve_nas.Hparams(
        num_cells=3, num_conv_filters=8, compute_dtype=jnp.float32, use_pallas_sep_conv=True
    )
    module = jax_improve_nas.Builder(None, hp, num_classes=10).build_subnetwork(10)
    shapes = variable_shapes(module, {"image": images[:1]})
    variables = [numpy_variables(shapes, seed=s, trained_stats=True) for s in (11, 12)]
    apply = jax.jit(lambda v, x: module.apply(v, {"image": x}, training=False))
    member_outs = [apply(v, images) for v in variables]
    ensembler = JaxEnsembler(mixture_weight_type=JaxWeightType.SCALAR, use_fused_combine=True)
    params = {"weights": [jnp.float32(w) for w in MIXTURE]}
    ensemble = ensembler.build_ensemble(params, member_outs)
    want = JaxHead(10).predictions(ensemble.logits)
    want = {k: np.asarray(v) for k, v in want.items()}
    return requests, variables, want


def _frozen(variables):
    builder = improve_nas.Builder(
        None,
        improve_nas.Hparams(
            num_cells=3,
            num_conv_filters=8,
            compute_dtype=torch.float32,
            use_pallas_sep_conv=True,
        ),
        num_classes=10,
    )
    architecture = Architecture("t1_nasnet_grow", "complexity_regularized", iteration_number=1)
    params = convert.convert_ensembler_params({"weights": [np.float32(w) for w in MIXTURE]})
    members = []
    for t, v in enumerate(variables):
        module = builder.build_subnetwork(10, input_shape=SHAPE)
        module.load_state_dict(convert.convert_variables(v), strict=True)
        architecture.add_subnetwork(t, builder.name)
        members.append(
            FrozenWeightedSubnetwork(
                subnetwork=FrozenSubnetwork(
                    iteration_number=t,
                    name=builder.name,
                    module=module.eval(),
                    complexity=1.0,
                    builder_spec=builder.to_spec(),
                ),
                weight=params["weights"][t],
            )
        )
    return FrozenEnsemble(
        name="t1_nasnet_grow",
        iteration_number=1,
        weighted_subnetworks=members,
        ensembler_name="complexity_regularized",
        ensembler_params=params,
        architecture=architecture,
    )


def _publish(model_dir, variables, t=1):
    from adanet_tpu_torch.core import export

    ensembler = ComplexityRegularizedEnsembler(
        mixture_weight_type=MixtureWeightType.SCALAR, use_fused_combine=True
    )
    sample = {"image": np.zeros((1,) + SHAPE, np.float32)}
    predict_fn = export.frozen_predict_fn(_frozen(variables), ensembler, MultiClassHead(10))
    return publish_generation(model_dir, t, predict_fn, sample, device="cpu")


def test_served_predictions_match_jax(tmp_path, reference):
    requests, variables, want = reference
    model_dir = str(tmp_path / "model")
    gen = _publish(model_dir, variables)
    assert sorted(os.listdir(gen)) == [
        "generation.json",
        "serving.pt2",
        "serving_signature.json",
    ]
    assert _publish(model_dir, variables) is None  # set-once

    pool = ModelPool(model_dir, device="cpu")
    assert pool.poll() and pool.active.iteration_number == 1
    frontend = ServingFrontend(Batcher(pool)).start()
    try:
        handles = [frontend.submit_async({"image": r}, deadline_secs=120.0) for r in requests]
        results = [h.wait(180.0) for h in handles]
    finally:
        assert frontend.drain(timeout=60.0)
    offset = 0
    for request, result in zip(requests, results):
        assert result.ok, result
        assert result.generation == 1
        rows = slice(offset, offset + len(request))
        offset += len(request)
        out = result.outputs
        assert out["logits"].shape == (len(request), 10)
        np.testing.assert_allclose(out["logits"], want["logits"][rows], atol=1e-4, rtol=0)
        np.testing.assert_allclose(
            out["probabilities"], want["probabilities"][rows], atol=1e-5, rtol=0
        )
        np.testing.assert_array_equal(out["class_ids"], want["class_ids"][rows])
    assert frontend.counters["error"] == 0


def test_pool_rejects_corrupt_generation_and_keeps_serving(tmp_path, reference):
    _, variables, _ = reference
    model_dir = str(tmp_path / "model")
    _publish(model_dir, variables, t=1)
    pool = ModelPool(model_dir, device="cpu")
    assert pool.poll() and pool.active.iteration_number == 1
    gen2 = _publish(model_dir, variables, t=2)
    path = os.path.join(gen2, "serving.pt2")
    data = bytearray(open(path, "rb").read())
    data[len(data) // 2] ^= 0xFF
    with open(path, "wb") as f:
        f.write(bytes(data))
    assert integrity.verify_serving_generation(gen2) == ["digest mismatch or missing file: serving.pt2"]
    assert pool.poll()
    assert pool.active.iteration_number == 1
    assert pool.rollbacks == 1 and pool.events[-1]["event"] == "rollback"
    assert not pool.poll()  # a rejected generation is not retried
    assert os.path.isdir(gen2 + ".corrupt")  # and is quarantined


def test_frontend_rejects_oversized_and_unavailable(tmp_path):
    pool = ModelPool(str(tmp_path / "empty"), device="cpu")
    frontend = ServingFrontend(Batcher(pool))
    big = frontend.submit({"image": np.zeros((33,) + SHAPE, np.float32)})
    assert big.status == "invalid_argument"
    early = frontend.submit({"image": np.zeros((1,) + SHAPE, np.float32)})
    assert early.status == "unavailable"


def test_served_weights_are_prepared_once(tmp_path, reference):
    """The loaded program's constants (the ensembler weights among them)
    are ordinary tensors (moved outside `torch.inference_mode`), so they
    carry a version counter, keep their identity across calls, and K1's
    custom op prepares them on the first served call only."""
    from adanet_tpu_torch.core import export
    from adanet_tpu_torch.ops import sepconv_kernels

    requests, variables, want = reference
    gen = _publish(str(tmp_path / "model"), variables)
    predict = export.load_serving_program(gen, device="cpu")
    constants = [v for m in predict.module.modules() for v in vars(m).values() if torch.is_tensor(v)]
    assert constants and all(not c.is_inference() for c in constants)
    before = sepconv_kernels.prepare.made
    first = predict({"image": requests[0]})
    assert sepconv_kernels.prepare.made == before + 1
    second = predict({"image": requests[0]})
    assert sepconv_kernels.prepare.made == before + 1
    assert torch.equal(first["logits"], second["logits"])
    np.testing.assert_allclose(first["logits"].numpy(), want["logits"][: len(requests[0])], atol=1e-4, rtol=0)
