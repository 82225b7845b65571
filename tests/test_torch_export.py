"""The port's hermetic export (`core/export.py` on `torch.export`) and
`Estimator.export_saved_model`, on the CPU.

Copies of tests/test_estimator.py's export tests
(`test_export_serving_program_round_trip`,
`test_multi_head_export_with_member_outputs`,
`test_export_is_multi_platform` with the platforms {cuda, cpu},
`test_export_subnetwork_outputs_in_predict`) and of
tests/test_serving.py's `test_export_records_multi_platform_fallback_reason`
(the port's platform check forced to fail); a served program in a
subprocess that imports only torch, numpy and `adanet_tpu_torch.ops`,
bitwise the in-process `predict` at batches 1 and 7; the port's program
of a converted simple_dnn ensemble against the JAX package's exported
program on the same numpy inputs (f32, atol 1e-5); and a NASNet-A
winner's export.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from adanet_tpu_torch.core import checkpoint as ckpt_lib
from adanet_tpu_torch.core import export as export_lib
from adanet_tpu_torch.core.estimator import Estimator
from adanet_tpu_torch.core.export import load_serving_program, serving_signature
from adanet_tpu_torch.core.heads import MultiClassHead, MultiHead, RegressionHead
from adanet_tpu_torch.ensemble.weighted import ComplexityRegularizedEnsembler
from adanet_tpu_torch.subnetwork.generator import SimpleGenerator
from torch_port_common import dnn_builder, linear_dataset, one_torch_thread

_one_torch_thread = pytest.fixture(autouse=True)(one_torch_thread)

HERE = os.path.dirname(os.path.abspath(__file__))


def _sgd(lr):
    return lambda params: torch.optim.SGD(params, lr=lr)


def _make_estimator(tmp_path, **kwargs):
    defaults = dict(
        head=RegressionHead(),
        subnetwork_generator=SimpleGenerator([dnn_builder("dnn", 1), dnn_builder("deep", 2)]),
        max_iteration_steps=8,
        ensemblers=[ComplexityRegularizedEnsembler(optimizer=_sgd(0.05))],
        model_dir=str(tmp_path / "model"),
        log_every_steps=0,
        device="cpu",
    )
    defaults.update(kwargs)
    return Estimator(**defaults)


def test_export_serving_program_round_trip(tmp_path):
    """The serialized program predicts without any model code."""
    est = _make_estimator(tmp_path, max_iterations=1)
    est.train(linear_dataset(), max_steps=8)
    sample = next(linear_dataset()())
    export_dir = est.export_saved_model(str(tmp_path / "export"), sample)

    served = load_serving_program(export_dir, device="cpu")
    out = served(sample[0])
    assert out["predictions"].shape == (16, 1)
    # Must match the in-framework predict path.
    expected = next(iter(est.predict(linear_dataset())))
    np.testing.assert_allclose(np.asarray(out["predictions"]), expected["predictions"], rtol=1e-5, atol=1e-6)
    signature = serving_signature(export_dir)
    assert signature["outputs"]["predictions"]["shape"] == ["batch", "1"]
    # Polymorphic batch: the served program accepts other batch sizes.
    out3 = served({"x": np.ones((3, 2), np.float32)})
    assert out3["predictions"].shape == (3, 1)


def test_export_saved_model_writes_the_durable_payload(tmp_path):
    est = _make_estimator(tmp_path, max_iterations=1)
    with pytest.raises(ValueError, match="Nothing to export; train first."):
        est.export_saved_model(str(tmp_path / "early"), next(linear_dataset()()))
    est.train(linear_dataset(), max_steps=8)
    export_dir = est.export_saved_model(str(tmp_path / "export"), next(linear_dataset()()), serialize_program=False)
    assert sorted(os.listdir(export_dir)) == ["architecture.json", "ensemble.pt", "ensemble.pt.sha256"]
    payload = ckpt_lib.restore_payload(export_dir, "ensemble.pt")
    assert payload["iteration_number"] == 0 and payload["name"].startswith("t0_")
    with open(os.path.join(export_dir, "architecture.json")) as f:
        assert f.read() == open(os.path.join(est.model_dir, "architecture-0.json")).read()


def test_multi_head_export_with_member_outputs(tmp_path):
    """export_subnetwork_logits/last_layer compose with multi-head dict
    outputs through predict AND the serialized serving program."""
    head = MultiHead([RegressionHead(name="reg"), MultiClassHead(3, name="cls")])
    rng = np.random.RandomState(0)

    def input_fn():
        for _ in range(4):
            x = rng.randn(16, 4).astype(np.float32)
            yield {"x": x}, {"reg": x.sum(axis=1, keepdims=True), "cls": np.zeros((16,), np.int32)}

    from adanet_tpu_torch.subnetwork.generator import Builder, Subnetwork

    class _M(torch.nn.Module):
        def __init__(self, logits_dimension):
            super().__init__()
            self.hidden = torch.nn.Linear(4, 8)
            self.names = sorted(logits_dimension)
            self.out = torch.nn.ModuleDict({k: torch.nn.Linear(8, d) for k, d in logits_dimension.items()})

        def forward(self, features, training=False):
            h = torch.relu(self.hidden(features["x"].float()))
            return Subnetwork(last_layer=h, logits={k: self.out[k](h) for k in self.names}, complexity=1.0)

    class _B(Builder):
        @property
        def name(self):
            return "b"

        def build_subnetwork(self, logits_dimension, previous_ensemble=None, *, input_shape=None):
            return _M(logits_dimension)

        def build_train_optimizer(self, previous_ensemble=None):
            return lambda named: torch.optim.SGD([p for _, p in named], lr=0.05)

    est = _make_estimator(
        tmp_path,
        head=head,
        subnetwork_generator=SimpleGenerator([_B()]),
        max_iterations=1,
        max_iteration_steps=4,
        export_subnetwork_logits=True,
        export_subnetwork_last_layer=True,
    )
    est.train(input_fn, max_steps=4)
    features = {"x": np.ones((5, 4), np.float32)}
    preds = next(iter(est.predict(lambda: iter([features]))))
    assert preds["subnetwork_logits/0"]["reg"].shape == (5, 1)
    assert preds["subnetwork_logits/0"]["cls"].shape == (5, 3)
    assert preds["subnetwork_last_layer/0"].shape == (5, 8)
    export_dir = est.export_saved_model(str(tmp_path / "export"), (features, None))
    served = load_serving_program(export_dir, device="cpu")(features)
    assert served["subnetwork_logits/0"]["cls"].shape == (5, 3)
    for key in ("reg/predictions", "cls/logits", "cls/probabilities", "cls/class_ids"):
        assert torch.equal(served[key], preds[key]), key
    assert torch.equal(served["subnetwork_logits/0"]["reg"], preds["subnetwork_logits/0"]["reg"])
    assert torch.equal(served["subnetwork_last_layer/0"], preds["subnetwork_last_layer/0"])
    outputs = serving_signature(export_dir)["outputs"]
    assert outputs["subnetwork_logits/0"]["cls"]["shape"] == ["batch", "3"]


def test_export_is_multi_platform(tmp_path):
    """The program declares cuda AND cpu (exported on one, served on
    either): the CPU export's graph runs on fake CUDA tensors at export
    and the file serves here on the CPU."""
    est = _make_estimator(tmp_path, max_iterations=1)
    est.train(linear_dataset(), max_steps=8)
    sample = next(linear_dataset()())
    export_dir = est.export_saved_model(str(tmp_path / "export"), sample)
    signature = serving_signature(export_dir)
    assert set(signature["platforms"]) >= {"cuda", "cpu"}
    assert signature["multi_platform_fallback_reason"] is None
    out = load_serving_program(export_dir, device="cpu")({"x": np.zeros((3, 2), np.float32)})
    assert out["predictions"].shape == (3, 1)


def test_export_subnetwork_outputs_in_predict(tmp_path):
    """Per-member logits/last layers in predictions."""
    est = _make_estimator(tmp_path, max_iterations=2, export_subnetwork_logits=True,
                          export_subnetwork_last_layer=True)
    est.train(linear_dataset(), max_steps=100)
    preds = next(iter(est.predict(linear_dataset())))
    assert "subnetwork_logits/0" in preds
    assert "subnetwork_logits/1" in preds  # 2 members after 2 iterations
    assert preds["subnetwork_logits/0"].shape == (16, 1)
    assert preds["subnetwork_last_layer/0"].shape[0] == 16


def test_export_records_multi_platform_fallback_reason(tmp_path, monkeypatch):
    """A multi-platform export that became single-platform records why."""
    real = export_lib._check_platform

    def fails_on_cuda(program, platform, user_inputs):
        if platform == "cuda":
            raise ValueError("lowering is specialized to cpu; multi-platform serialization unsupported for this op")
        return real(program, platform, user_inputs)

    monkeypatch.setattr(export_lib, "_check_platform", fails_on_cuda)
    export_lib.export_serving_program(
        str(tmp_path / "export"), lambda features: {"y": torch.tanh(features["x"])},
        {"x": np.zeros((2, 3), np.float32)}, device="cpu",
    )
    signature = serving_signature(str(tmp_path / "export"))
    reason = signature["multi_platform_fallback_reason"]
    assert reason is not None
    assert "multi-platform serialization unsupported" in reason
    assert signature["requested_platforms"] == ["cuda", "cpu"]
    assert signature["platforms"] == ["cpu"]
    # The batch dimension still exported polymorphic: only the platform
    # capability degraded, and only it carries a reason.
    assert signature["polymorphic_fallback_reason"] is None


def test_export_records_polymorphic_fallback_reason(tmp_path, monkeypatch):
    real = torch.export.export

    def no_dynamic(module, args, dynamic_shapes=None, **kwargs):
        if dynamic_shapes is not None:
            raise RuntimeError("batch dimension specialized by the model")
        return real(module, args, **kwargs)

    monkeypatch.setattr(torch.export, "export", no_dynamic)
    export_lib.export_serving_program(
        str(tmp_path / "export"), lambda features: {"y": torch.tanh(features["x"])},
        {"x": np.zeros((3, 2), np.float32)}, device="cpu",
    )
    signature = serving_signature(str(tmp_path / "export"))
    assert "batch dimension specialized" in signature["polymorphic_fallback_reason"]
    assert signature["inputs"]["x"]["shape"] == ["3", "2"]
    assert signature["multi_platform_fallback_reason"] is None
    served = load_serving_program(str(tmp_path / "export"), device="cpu")
    assert served({"x": np.ones((3, 2), np.float32)})["y"].shape == (3, 2)
    with pytest.raises(Exception):
        served({"x": np.ones((4, 2), np.float32)})


def test_served_in_a_process_without_model_code(tmp_path):
    """A weighted two-member classification winner (K1's custom op in
    its graph) served at batches 1 and 7 by tests/torch_serve_runner.py,
    which imports only torch, numpy and the kernels' custom ops: bitwise
    the in-process predict."""
    x, y = np.random.RandomState(4).randn(64, 2).astype(np.float32), None
    labels = (x[:, 0] > 0).astype(np.int64) + (x[:, 1] > 0)

    def input_fn():
        for start in range(0, 64, 16):
            yield {"x": x[start:start + 16]}, labels[start:start + 16]

    est = _make_estimator(tmp_path, head=MultiClassHead(3), max_iterations=2,
                          ensemblers=[ComplexityRegularizedEnsembler(optimizer=_sgd(0.05), use_fused_combine=True)])
    est.train(input_fn, max_steps=100)
    export_dir = est.export_saved_model(str(tmp_path / "export"), ({"x": x[:1]}, None))
    program = torch.export.load(os.path.join(export_dir, "serving.pt2"))
    assert any("weighted_combine" in str(n.target) for n in program.graph.nodes)
    requests = {"0/x": x[:1], "1/x": x[1:8]}
    np.savez(str(tmp_path / "requests.npz"), **requests)
    out = subprocess.run([sys.executable, os.path.join(HERE, "torch_serve_runner.py"), export_dir,
                          str(tmp_path / "requests.npz"), str(tmp_path / "served.npz"), "cpu"],
                         capture_output=True, text=True, timeout=300, env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr[-3000:]
    served = np.load(str(tmp_path / "served.npz"))
    modules = list(served["__modules__"])
    assert "adanet_tpu_torch.ops.ensemble_kernels" in modules
    assert not [m for m in modules if m.startswith(("adanet_tpu_torch.core", "adanet_tpu_torch.examples",
                                                      "adanet_tpu_torch.models", "adanet_tpu_torch.ensemble"))]
    for index, rows in enumerate((x[:1], x[1:8])):
        want = next(iter(est.predict(lambda: iter([{"x": rows}]))))
        for key, value in want.items():
            np.testing.assert_array_equal(served["%d/%s" % (index, key)], value.numpy(), err_msg=key)


def test_port_program_matches_the_jax_program(tmp_path):
    """A converted two-member simple_dnn ensemble (SCALAR weights, the
    fused combine): the port's exported program against the JAX
    package's exported program on the same inputs (f32, atol 1e-5),
    at two batch sizes."""
    import jax.numpy as jnp

    from adanet_tpu.core import export as jax_export
    from adanet_tpu.core.heads import MultiClassHead as JaxHead
    from adanet_tpu.ensemble import ComplexityRegularizedEnsembler as JaxEnsembler
    from adanet_tpu.ensemble import MixtureWeightType as JaxWeightType
    from adanet_tpu.examples import simple_dnn as jax_simple_dnn

    from adanet_tpu_torch.core.architecture import Architecture
    from adanet_tpu_torch.core.frozen import FrozenEnsemble, FrozenSubnetwork, FrozenWeightedSubnetwork
    from adanet_tpu_torch.ensemble.weighted import MixtureWeightType
    from adanet_tpu_torch.examples import simple_dnn
    from adanet_tpu_torch.utils import convert

    mixture = [0.6, 0.35]
    layers = (1, 2)
    variables = [convert.simple_dnn_variables(n, 8, 4, 5, seed=20 + n) for n in layers]
    jax_modules = [jax_simple_dnn._DNNBuilder(None, 8, n, False, 0.0, 0).build_subnetwork(5) for n in layers]
    jax_ensembler = JaxEnsembler(mixture_weight_type=JaxWeightType.SCALAR, use_fused_combine=True)

    def jax_predict(features):
        outs = [m.apply(v, features, training=False) for m, v in zip(jax_modules, variables)]
        ensemble = jax_ensembler.build_ensemble({"weights": [jnp.float32(w) for w in mixture]}, outs)
        return JaxHead(5).predictions(ensemble.logits)

    sample = {"x": np.zeros((2, 4), np.float32)}
    jax_export.export_serving_program(str(tmp_path / "jax"), jax_predict, sample)
    jax_served = jax_export.load_serving_program(str(tmp_path / "jax"))

    members = []
    for n, v in zip(layers, variables):
        module = simple_dnn._DNNBuilder(None, 8, n, False, 0.0, 0).build_subnetwork(5, input_shape=(4,))
        module.load_state_dict(convert.convert_simple_dnn(v), strict=True)
        members.append(FrozenWeightedSubnetwork(FrozenSubnetwork(n, "dnn", module.eval(), 1.0)))
    params = convert.convert_ensembler_params({"weights": [np.float32(w) for w in mixture]})
    frozen = FrozenEnsemble("t1", 1, members, "complexity_regularized", params,
                            Architecture("t1", "complexity_regularized"))
    ensembler = ComplexityRegularizedEnsembler(mixture_weight_type=MixtureWeightType.SCALAR, use_fused_combine=True)
    export_lib.export_serving_program(str(tmp_path / "port"), export_lib.frozen_predict_fn(
        frozen, ensembler, MultiClassHead(5)), sample, device="cpu")
    served = load_serving_program(str(tmp_path / "port"), device="cpu")
    rng = np.random.RandomState(9)
    jax_rows = 2 if serving_signature(str(tmp_path / "jax"))["polymorphic_fallback_reason"] else 7
    for _ in range(3):
        features = {"x": rng.randn(jax_rows, 4).astype(np.float32)}
        want = {k: np.asarray(v) for k, v in jax_served(features).items()}
        got = {k: v.numpy() for k, v in served(features).items()}
        np.testing.assert_allclose(got["logits"], want["logits"], rtol=0, atol=1e-5)
        np.testing.assert_allclose(got["probabilities"], want["probabilities"], rtol=0, atol=1e-5)
        np.testing.assert_array_equal(got["class_ids"], want["class_ids"])
    assert serving_signature(str(tmp_path / "port"))["polymorphic_fallback_reason"] is None
    for rows in (1, 7):
        assert served({"x": rng.randn(rows, 4).astype(np.float32)})["logits"].shape == (rows, 5)


def test_nasnet_winner_exports(tmp_path):
    """A NASNet-A search's winner (improve_nas, 3 cells, 4 filters, f32,
    K2's custom op in its graph) exports and serves bitwise the
    in-process predict at batches 1 and 7."""
    from adanet_tpu_torch.research.improve_nas import improve_nas, optimizer

    rng = np.random.RandomState(2)
    images = rng.rand(32, 16, 16, 3).astype(np.float32)
    labels = rng.randint(0, 10, 32)

    def input_fn():
        for start in range(0, 32, 16):
            yield {"image": images[start:start + 16]}, labels[start:start + 16]

    hparams = improve_nas.Hparams(num_cells=3, num_conv_filters=4, compute_dtype=torch.float32,
                                  use_pallas_sep_conv=True)
    est = Estimator(MultiClassHead(10), improve_nas.Generator(optimizer.fn_with_name("sgd"), hparams, seed=0), 2, max_iterations=1,
                    model_dir=str(tmp_path / "model"), log_every_steps=0, device="cpu")
    est.train(input_fn, max_steps=2)
    export_dir = est.export_saved_model(str(tmp_path / "export"), ({"image": images[:1]}, None))
    program = torch.export.load(os.path.join(export_dir, "serving.pt2"))
    assert any("sep_conv" in str(n.target) for n in program.graph.nodes)
    served = load_serving_program(export_dir, device="cpu")
    for rows in (images[:1], images[1:8]):
        want = next(iter(est.predict(lambda: iter([{"image": rows}]))))
        got = served({"image": rows})
        for key in want:
            assert torch.equal(got[key], want[key]), key


def test_serving_example_tutorial(capsys):
    """The tutorial trains the two-head search, exports it and serves
    batches 1 and 7 from a process without model code."""
    from adanet_tpu_torch.examples.tutorials import serving_example

    lines = serving_example.main(["--device", "cpu"])
    assert [line["batch_size"] for line in lines[:-1]] == [1, 7]
    assert lines[1]["outputs"]["cls/logits"] == [7, 3]
    assert "OK: hermetic multi-head serving round trip" in capsys.readouterr().out
