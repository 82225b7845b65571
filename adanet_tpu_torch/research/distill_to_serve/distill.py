"""Distill a frozen ensemble into a single-program cascade level 0.

Port of research/distill_to_serve/distill.py. The driver behind the "KD
student as level 0" serving mode:

1. **Teacher**: the frozen full ensemble, either a live predict fn or a
   published generation's hermetic program (`teacher_from_generation`,
   `load_serving_program` on the caller's device).
2. **Student** (`distill_student`): a small MLP (`StudentMLP`, drawn from
   an explicit generator) trained with the born-again objective of
   `research/improve_nas` (`_distillation_loss(student_logits,
   teacher_logits)`: cross entropy against the teacher's soft labels, no
   ground-truth labels anywhere) under Adam.
3. **Publication** (`distill_and_publish`): the student rides the
   standard cascade publication (`serving/publisher.py`) as the
   generation's `cascade.pt2`, calibrated with `source="distilled"` in
   the signature's cascade block; the teacher is exported again as the
   generation's `serving.pt2`. A loaded teacher re-exports through its
   graph module (`predict.module`): the same graph, the K1 custom op
   node included, so the served full program computes what the teacher
   computed.

The student's output tree is rebuilt to be congruent with the teacher's
(the flip gate rejects incongruent cascades), with probability and class
leaves derived from the student's own logits.

Demo driver (synthetic teacher, publishes generation 0):

    python -m adanet_tpu_torch.research.distill_to_serve.distill /tmp/distilled-model [--device cpu]
"""

from __future__ import annotations

import dataclasses
import logging
import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from adanet_tpu_torch._device import resolve_device
from adanet_tpu_torch.research.improve_nas.improve_nas import _distillation_loss

_LOG = logging.getLogger("adanet_tpu_torch")

# Flax's lecun_normal: a normal truncated at two standard deviations,
# scaled so that its variance is 1 / fan_in.
_TRUNCATED_STD = 0.87962566103423978


@dataclasses.dataclass
class DistillConfig:
    """Student architecture and born-again training schedule."""

    hidden: Tuple[int, ...] = (64, 64)
    steps: int = 400
    learning_rate: float = 1e-3
    seed: int = 0
    #: Key of the logits leaf in the teacher's output tree (the cascade
    #: record's `logits_key`).
    logits_key: str = "predictions"
    target_agreement: float = 0.995


def _feature_leaves(features) -> List[Any]:
    """Leaves in the JAX package's tree order (dict keys sorted)."""
    if isinstance(features, dict):
        return [leaf for key in sorted(features) for leaf in _feature_leaves(features[key])]
    if isinstance(features, (list, tuple)):
        return [leaf for item in features for leaf in _feature_leaves(item)]
    return [features]


class StudentMLP(torch.nn.Module):
    """The distilled level-0 program body: flatten every feature leaf,
    concatenate, and run a small MLP to the teacher's logits width.
    Dense layers as Flax draws them (lecun-normal kernels, zero biases),
    from `generator`."""

    def __init__(self, in_features: int, hidden: Sequence[int], num_outputs: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        widths = [int(in_features)] + [int(w) for w in hidden]
        self.dense = torch.nn.ModuleList(torch.nn.Linear(a, b) for a, b in zip(widths[:-1], widths[1:]))
        self.logits = torch.nn.Linear(widths[-1], int(num_outputs))
        with torch.no_grad():
            for layer in list(self.dense) + [self.logits]:
                std = math.sqrt(1.0 / layer.in_features) / _TRUNCATED_STD
                torch.nn.init.trunc_normal_(layer.weight, std=std, a=-2 * std, b=2 * std, generator=generator)
                layer.bias.zero_()

    def forward(self, features):
        x = torch.cat([leaf.float().reshape(leaf.shape[0], -1) for leaf in _feature_leaves(features)], dim=-1)
        for layer in self.dense:
            x = torch.relu(layer(x))
        return self.logits(x)


def _to_host(tree):
    from adanet_tpu_torch.serving.model_pool import to_host

    return to_host(tree)


def _logits_leaf(outputs: Any, logits_key: str) -> np.ndarray:
    outputs = _to_host(outputs)
    return np.asarray(outputs[logits_key] if isinstance(outputs, dict) else outputs)


def _on_device(features, device):
    from adanet_tpu_torch.core.export import _map, _tensor

    return _map(lambda x: _tensor(x, device), features)


def _student_outputs_like(template: Any, logits_key: str):
    """`logits -> output tree` congruent with the teacher's.

    Derived leaves come from the student's logits (softmax
    probabilities, argmax class ids, sigmoid logistic), never from the
    teacher, which is absent at serve time. Unknown keys raise here, at
    build time, rather than failing the flip gate later.
    """
    if not isinstance(template, dict):
        return lambda logits: logits

    def build(logits) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for key in template:
            if key in (logits_key, "logits", "predictions"):
                out[key] = logits
            elif key == "probabilities":
                out[key] = torch.softmax(logits, dim=-1)
            elif key == "class_ids":
                out[key] = torch.argmax(logits, dim=-1)
            elif key == "logistic":
                out[key] = torch.sigmoid(logits)
            else:
                raise ValueError(
                    "Cannot derive teacher output leaf %r from student logits; distillation cannot produce a "
                    "congruent level-0 tree." % key
                )
        return out

    return build


def distill_student(
    teacher_fn: Callable,
    feature_batches: Sequence[Any],
    config: Optional[DistillConfig] = None,
    device="cuda",
) -> Tuple[Callable, Dict[str, Any]]:
    """Trains a born-again student against the frozen teacher on `device`.

    Teacher logits are computed once per batch, outside the update (the
    teacher may be a loaded program), then cycled for `config.steps`
    steps. The student is drawn from `torch.Generator().manual_seed(
    config.seed)`. Returns `(predict_fn,
    report)`: `predict_fn(features)` emits a tree congruent with the
    teacher's, ready for `CascadeSpec.predict_fn`; the report carries the
    final loss, every step's loss and the train-stream argmax agreement
    with the teacher.
    """
    config = config or DistillConfig()
    dev = resolve_device(device)
    if not feature_batches:
        raise ValueError("feature_batches must be non-empty.")
    targets: List[np.ndarray] = []
    template = None
    for features in feature_batches:
        outputs = teacher_fn(features)
        if template is None:
            template = outputs
        targets.append(_logits_leaf(outputs, config.logits_key))
    num_outputs = int(targets[0].shape[-1])
    in_features = sum(int(np.prod(np.shape(leaf)[1:])) for leaf in _feature_leaves(feature_batches[0]))
    student = StudentMLP(in_features, config.hidden, num_outputs,
                         generator=torch.Generator().manual_seed(config.seed)).to(dev)
    batches = [_on_device(features, dev) for features in feature_batches]
    teacher_logits = [torch.from_numpy(np.ascontiguousarray(t)).to(dev) for t in targets]
    optimizer = torch.optim.Adam(student.parameters(), lr=config.learning_rate, eps=1e-8)
    losses = []
    for step in range(config.steps):
        batch = step % len(batches)
        optimizer.zero_grad(set_to_none=True)
        loss = _distillation_loss(student(batches[batch]), teacher_logits[batch])
        loss.backward()
        optimizer.step()
        losses.append(loss.detach())
    losses = [float(v) for v in torch.stack(losses).cpu()] if losses else []
    agree = total = 0
    with torch.no_grad():
        for features, target in zip(batches, targets):
            student_logits = student(features).cpu().numpy()
            agree += int(np.sum(student_logits.argmax(-1) == target.argmax(-1)))
            total += len(target)
    student.eval()
    build = _student_outputs_like(template, config.logits_key)

    def predict_fn(features):
        return build(student(features))

    predict_fn.module = student
    report = {
        "final_loss": losses[-1] if losses else None,
        "losses": losses,
        "steps": int(config.steps),
        "train_rows": int(total),
        "teacher_agreement": float(agree) / float(max(total, 1)),
    }
    _LOG.info("Distilled student: %s", {k: v for k, v in report.items() if k != "losses"})
    return predict_fn, report


def teacher_from_generation(gen_dir: str, device="cuda") -> Callable:
    """The published full-ensemble program as a teacher callable, loaded
    onto `device` (`load_serving_program`): no model code, no parameters
    outside the program, exactly the frozen artifact the student must
    shadow."""
    from adanet_tpu_torch.core import export as export_lib

    return export_lib.load_serving_program(gen_dir, device=device)


def distill_and_publish(
    model_dir: str,
    iteration_number: int,
    teacher_fn: Callable,
    feature_batches: Sequence[Any],
    config: Optional[DistillConfig] = None,
    calibration_features: Any = None,
    store=None,
    device="cuda",
) -> Optional[str]:
    """Distills a student and publishes teacher and student as one
    generation: the ensemble as the serving program, the student as its
    calibrated `cascade.pt2` level 0 (`source="distilled"`).

    A teacher loaded by `teacher_from_generation` is exported through its
    graph module, so the generation's full program is the teacher's graph.
    `calibration_features` defaults to the concatenated training stream;
    pass a held-out stream for honest thresholds. Returns the published
    directory (None when the generation already exists; publication is
    set-once).
    """
    from adanet_tpu_torch.core.export import _canonical
    from adanet_tpu_torch.serving import publisher
    from adanet_tpu_torch.serving.fleet import cascade as cascade_lib

    config = config or DistillConfig()
    dev = resolve_device(device)
    predict_fn, _ = distill_student(teacher_fn, feature_batches, config, device=dev)
    if calibration_features is None:
        from adanet_tpu_torch.serving.batcher import _map as map_trees

        calibration_features = map_trees(
            lambda *leaves: np.concatenate([np.asarray(leaf) for leaf in leaves], axis=0), *feature_batches)
    spec = cascade_lib.CascadeSpec(
        predict_fn=predict_fn,
        calibration_features=calibration_features,
        logits_key=config.logits_key,
        target_agreement=config.target_agreement,
        source="distilled",
    )
    graph = getattr(teacher_fn, "module", None)
    full_fn = teacher_fn if graph is None else (lambda features: graph(_canonical(features)))
    return publisher.publish_generation(
        model_dir, iteration_number, full_fn, _to_host(feature_batches[0]), store=store, cascade=spec, device=dev)


def _demo(argv: Optional[List[str]] = None) -> int:
    """Synthetic end-to-end run: teacher MLP -> student -> publication."""
    import argparse
    import json
    import os

    parser = argparse.ArgumentParser(prog="python -m adanet_tpu_torch.research.distill_to_serve.distill")
    parser.add_argument("out_dir")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    rng = np.random.RandomState(0)
    hidden = torch.from_numpy(rng.randn(16, 64).astype(np.float32)).to(dev)
    head = torch.from_numpy(rng.randn(64, 4).astype(np.float32)).to(dev)

    def teacher_fn(features):
        x = torch.as_tensor(features["x"], device=dev)
        return {"predictions": torch.tanh(x @ hidden) @ head}

    batches = [{"x": rng.randn(64, 16).astype(np.float32)} for _ in range(8)]
    published = distill_and_publish(args.out_dir, 0, teacher_fn, batches, DistillConfig(steps=200), device=dev)
    if published is None:
        print("generation 0 already published under %s" % args.out_dir)
        return 1
    from adanet_tpu_torch.core import export as export_lib

    signature = export_lib.serving_signature(published)
    print(json.dumps(signature["cascade"], indent=2, sort_keys=True))
    print("published %s" % os.path.abspath(published))
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(_demo())
