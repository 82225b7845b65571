"""The port's distillation into the cascade's level 0, on the CPU.

- `distill_student` against the JAX package's
  (research/distill_to_serve/distill.py) on the same teacher logits and
  the same student initialisation (the JAX `StudentMLP.init` at the
  config's seed, converted, in place of the port's draw): the loss of each of the first steps within
  1e-5 relative, and the trained student's logits within 1e-5;
- `distill_and_publish` over a real search's published generation
  (`teacher_from_generation`): the generation passes the port's gate with
  `cascade.source == "distilled"`, its full program keeps the teacher's
  K1 custom op and answers bitwise the teacher, and the batcher serves it
  with the cascade on.
"""

import os

import numpy as np
import pytest
import torch

from adanet_tpu_torch.research.distill_to_serve import (
    DistillConfig,
    StudentMLP,
    distill_and_publish,
    distill_student,
    teacher_from_generation,
)
from torch_port_common import one_torch_thread

_one_torch_thread = pytest.fixture(autouse=True)(one_torch_thread)

STEPS = 5
REL = 1e-5


def _teacher_and_batches():
    rng = np.random.RandomState(0)
    hidden = rng.randn(16, 32).astype(np.float32)
    head = rng.randn(32, 4).astype(np.float32)
    batches = [{"x": rng.randn(32, 16).astype(np.float32)} for _ in range(3)]

    def teacher_fn(features):
        return {"predictions": (np.tanh(np.asarray(features["x"]) @ hidden) @ head).astype(np.float32)}

    return teacher_fn, batches


def test_distill_student_matches_jax(monkeypatch):
    import jax

    from adanet_tpu_torch.research.distill_to_serve import distill
    from research.distill_to_serve import distill as jax_distill

    teacher_fn, batches = _teacher_and_batches()
    config = DistillConfig(hidden=(32, 16), steps=STEPS, learning_rate=1e-2, seed=3)
    jax_student = jax_distill.StudentMLP(tuple(config.hidden), 4)
    params = jax_student.init(jax.random.PRNGKey(config.seed), batches[0])["params"]

    def converted():
        student = StudentMLP(16, config.hidden, 4)
        with torch.no_grad():
            for i, layer in enumerate(student.dense):
                layer.weight.copy_(torch.from_numpy(np.asarray(params["dense_%d" % i]["kernel"]).T))
                layer.bias.copy_(torch.from_numpy(np.asarray(params["dense_%d" % i]["bias"])))
            student.logits.weight.copy_(torch.from_numpy(np.asarray(params["logits"]["kernel"]).T))
            student.logits.bias.copy_(torch.from_numpy(np.asarray(params["logits"]["bias"])))
        return student

    # The student the port draws, replaced by the JAX one's initial draw.
    monkeypatch.setattr(distill, "StudentMLP", lambda *args, **kwargs: converted())
    predict, report = distill_student(teacher_fn, batches, config, device="cpu")
    # The JAX driver reports only its last loss: a run of k steps gives
    # the loss of step k - 1.
    for k in range(1, STEPS + 1):
        jax_config = jax_distill.DistillConfig(hidden=config.hidden, steps=k, learning_rate=config.learning_rate,
                                               seed=config.seed)
        jax_predict, jax_report = jax_distill.distill_student(teacher_fn, batches, jax_config)
        np.testing.assert_allclose(report["losses"][k - 1], jax_report["final_loss"], rtol=REL)
    ours = predict({"x": torch.from_numpy(batches[1]["x"])})["predictions"].detach().numpy()
    theirs = np.asarray(jax_predict(batches[1])["predictions"])
    np.testing.assert_allclose(ours, theirs, rtol=REL, atol=REL)
    assert report["teacher_agreement"] == pytest.approx(jax_report["teacher_agreement"])


def test_student_init_is_flax_lecun_normal():
    """The port's own draw has Flax's statistics: truncated at two
    standard deviations, variance 1 / fan_in, zero biases."""
    student = StudentMLP(256, (512,), 4, generator=torch.Generator().manual_seed(0))
    w = student.dense[0].weight.detach().numpy()
    assert np.all(student.dense[0].bias.detach().numpy() == 0)
    assert abs(w.var() * 256 - 1.0) < 0.02
    assert np.abs(w).max() <= 2 * np.sqrt(1 / 256) / 0.87962566103423978 + 1e-6
    again = StudentMLP(256, (512,), 4, generator=torch.Generator().manual_seed(0))
    assert torch.equal(again.dense[0].weight, student.dense[0].weight)


def test_distill_and_publish_passes_the_gate(tmp_path):
    from adanet_tpu_torch.core import export as export_lib
    from adanet_tpu_torch.core.estimator import Estimator
    from adanet_tpu_torch.core.heads import MultiClassHead
    from adanet_tpu_torch.ensemble.weighted import ComplexityRegularizedEnsembler
    from adanet_tpu_torch.serving import Batcher, BatcherConfig, ModelPool, PoolConfig, publisher
    from adanet_tpu_torch.serving import batcher as batcher_lib
    from adanet_tpu_torch.serving.model_pool import gate_generation
    from adanet_tpu_torch.subnetwork.generator import SimpleGenerator
    from torch_port_common import dnn_builder

    rng = np.random.RandomState(0)
    x = rng.randn(128, 4).astype(np.float32)
    y = (x[:, 0] > 0).astype(np.int64) + (x[:, 1] > 0).astype(np.int64)

    def input_fn():
        for i in range(0, 128, 16):
            yield {"x": x[i:i + 16]}, y[i:i + 16]

    model_dir = str(tmp_path / "search")
    est = Estimator(MultiClassHead(3), SimpleGenerator([dnn_builder("a", 1), dnn_builder("b", 2)]),
                    max_iteration_steps=8, max_iterations=2,
                    ensemblers=[ComplexityRegularizedEnsembler(optimizer=lambda p: torch.optim.SGD(p, lr=0.05),
                                                               use_fused_combine=True)],
                    model_dir=model_dir, log_every_steps=0, device="cpu", export_serving=True)
    est.train(input_fn, max_steps=16)
    source = publisher.list_generations(model_dir)[-1][1]
    teacher = teacher_from_generation(source, device="cpu")
    batches = [{"x": rng.randn(32, 4).astype(np.float32)} for _ in range(4)]
    out_dir = str(tmp_path / "distilled")
    config = DistillConfig(steps=40, target_agreement=0.9, logits_key="logits")
    gen = distill_and_publish(out_dir, 1, teacher, batches, config, device="cpu")
    record = gate_generation(gen, torch.device("cpu"))
    assert record.cascade["source"] == "distilled" and record.cascade_program is not None

    def k1_nodes(path):
        return sum(1 for node in torch.export.load(path).graph.nodes
                   if node.op == "call_function" and "weighted_combine" in str(node.target))

    teacher_k1 = k1_nodes(os.path.join(source, export_lib.SERVING_FILE))
    assert teacher_k1 > 0
    assert k1_nodes(os.path.join(gen, export_lib.SERVING_FILE)) == teacher_k1
    probe = {"x": rng.randn(8, 4).astype(np.float32)}
    for key, value in teacher(probe).items():
        assert torch.equal(record.program(probe)[key], value), key
    pool = ModelPool(out_dir, PoolConfig(), device="cpu")
    assert pool.poll() and pool.active.cascade["source"] == "distilled"
    batcher = Batcher(pool, BatcherConfig(bucket_sizes=(8, 32)))
    _, (answer,) = batcher.execute([probe])
    assert batcher.cascade_stats()["active"] is True
    mask = batcher.last_row_fallthrough
    padded, _ = batcher_lib.pad_batch([probe], 8)
    want = batcher_lib.split_rows(record.cascade_program(padded), [8])[0]
    residual = np.flatnonzero(mask)
    if len(residual):
        rpadded, _ = batcher_lib.pad_batch([{"x": probe["x"][residual]}],
                                           batcher_lib.bucket_for(len(residual), (8, 32)))
        full = batcher_lib.split_rows(record.program(rpadded), [len(residual)])[0]
        for key in want:
            want[key][residual] = full[key]
    for key in want:
        np.testing.assert_array_equal(answer[key], want[key])
