"""improve_nas: NASNet-A subnetworks for AdaNet, with knowledge distillation.

Port of research/improve_nas/trainer/improve_nas.py (arXiv:1903.06236):
`Hparams`, the `Builder` that turns them into a NASNet-A subnetwork and
trains it (label smoothing, the auxiliary head's loss, ADAPTIVE or
BORN_AGAIN distillation, gradient clipping and weight decay on kernels
before the optimizer, `optimizer.Chain`), the module that wraps `NasNetA`
into the `Subnetwork` contract, and the generators: `Generator` (the same
architecture every iteration) and `DynamicGenerator` (one candidate 3
cells deeper and one 10 filters wider than the last frozen member).

A builder round-trips through a JSON spec (`to_spec` / `from_spec`), which
is how a published serving generation records how to rebuild its members.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Dict, List, Optional, Sequence

import torch
import torch.nn as nn

from adanet_tpu_torch.models.nasnet import NasNetA, NasNetConfig, init_parameters
from adanet_tpu_torch.research.improve_nas import optimizer as optimizer_lib
from adanet_tpu_torch.subnetwork.generator import Builder as BuilderBase
from adanet_tpu_torch.subnetwork.generator import Generator as GeneratorBase
from adanet_tpu_torch.subnetwork.generator import Subnetwork
from adanet_tpu_torch.subnetwork.report import Report

_PREVIOUS_NUM_CELLS = "num_cells"
_PREVIOUS_CONV_FILTERS = "num_conv_filters"

#: Builder kind recorded in serving specs.
KIND = "improve_nas"

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def dtype_name(dtype) -> str:
    for name, value in _DTYPES.items():
        if value == dtype:
            return name
    raise ValueError("unsupported compute dtype %r" % (dtype,))


def dtype_from_name(name: str):
    return _DTYPES[name]


class KnowledgeDistillation(str, enum.Enum):
    """Distillation modes (reference: improve_nas.py:44-57)."""

    NONE = "none"
    ADAPTIVE = "adaptive"
    BORN_AGAIN = "born_again"


@dataclasses.dataclass(frozen=True)
class Hparams:
    """Workload hyperparameters; defaults are NASNet-A (6@768) CIFAR."""

    num_cells: int = 18
    num_conv_filters: int = 32
    aux_head_weight: float = 0.4
    label_smoothing: float = 0.1
    weight_decay: float = 5e-4
    clip_gradients: float = 5.0
    knowledge_distillation: KnowledgeDistillation = KnowledgeDistillation.NONE
    initial_learning_rate: float = 0.025
    drop_path_keep_prob: float = 0.6
    dense_dropout_keep_prob: float = 1.0
    use_aux_head: bool = True
    total_training_steps: int = 937500
    stem_multiplier: float = 3.0
    compute_dtype: Any = torch.bfloat16
    remat: bool = False
    stem_type: str = "cifar"
    use_pallas_sep_conv: bool = False

    def replace(self, **kwargs) -> "Hparams":
        return dataclasses.replace(self, **kwargs)

    def to_dict(self) -> Dict[str, Any]:
        out = dataclasses.asdict(self)
        out["compute_dtype"] = dtype_name(self.compute_dtype)
        out["knowledge_distillation"] = KnowledgeDistillation(self.knowledge_distillation).value
        return out

    @classmethod
    def from_dict(cls, obj: Dict[str, Any]) -> "Hparams":
        obj = dict(obj)
        obj["compute_dtype"] = dtype_from_name(obj["compute_dtype"])
        obj["knowledge_distillation"] = KnowledgeDistillation(obj["knowledge_distillation"])
        return cls(**obj)


class _NasNetSubnetworkModule(nn.Module):
    """Wraps `NasNetA` into the `Subnetwork` contract."""

    def __init__(self, config: NasNetConfig, input_shape: Sequence[int]):
        super().__init__()
        self.config = config
        self.nasnet = NasNetA(config, input_shape)

    def init_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Flax's default initialisation (`models.nasnet.init_parameters`)."""
        init_parameters(self, generator)

    def forward(self, features, training: bool = False, generator=None) -> Subnetwork:
        images = features["image"] if isinstance(features, dict) else features
        logits, aux_logits, pooled = self.nasnet(images, training=training, generator=generator)
        return Subnetwork(
            last_layer=pooled,
            logits=logits,
            # Complexity hardcoded to 1, matching reference improve_nas.py:141.
            complexity=1.0,
            shared={
                _PREVIOUS_NUM_CELLS: self.config.num_cells,
                _PREVIOUS_CONV_FILTERS: self.config.num_conv_filters,
            },
            extras={"aux_logits": aux_logits},
        )


def _smoothed_softmax_cross_entropy(logits, labels, label_smoothing):
    """Mean softmax cross entropy against (optionally smoothed) one-hot
    labels, in f32."""
    num_classes = logits.shape[-1]
    onehot = torch.nn.functional.one_hot(labels.reshape(-1).long(), num_classes).float()
    if label_smoothing > 0:
        onehot = onehot * (1.0 - label_smoothing) + label_smoothing / num_classes
    return torch.mean(-torch.sum(onehot * torch.log_softmax(logits.float(), dim=-1), dim=-1))


def _distillation_loss(student_logits, teacher_logits):
    """Cross entropy of the student against the teacher's soft labels
    (reference: improve_nas.py:166-180), in f32."""
    soft = torch.softmax(teacher_logits.float(), dim=-1)
    return torch.mean(-torch.sum(soft * torch.log_softmax(student_logits.float(), dim=-1), dim=-1))


def _is_kernel(name: str) -> bool:
    """A conv or Dense kernel: the JAX builder decays the leaves named
    `kernel`, which the port names `weight` (`utils.convert`); batch
    norm's `scale` and `bias` and the Dense biases are not decayed."""
    return name.rsplit(".", 1)[-1] == "weight"


class Builder(BuilderBase):
    """Builds a NASNet-A subnetwork (reference: improve_nas.py:60-214).

    `optimizer_fn(learning_rate)` returns an `optimizer.Rule` (e.g. from
    `optimizer.fn_with_name`); None builds a subnetwork that cannot be
    trained (a served member rebuilt from its spec).
    """

    def __init__(
        self,
        optimizer_fn=None,
        hparams: Optional[Hparams] = None,
        seed: Optional[int] = None,
        num_classes: int = 10,
    ):
        self._optimizer_fn = optimizer_fn
        self._hparams = hparams or Hparams()
        self._seed = seed
        self._num_classes = num_classes

    @property
    def name(self) -> str:
        return "NasNet_A_{}_{}".format(self._hparams.num_cells, self._hparams.num_conv_filters)

    def build_subnetwork(self, logits_dimension, previous_ensemble=None, *, input_shape):
        hp = self._hparams
        config = NasNetConfig(
            num_classes=(
                logits_dimension if isinstance(logits_dimension, int) else self._num_classes
            ),
            num_cells=hp.num_cells,
            num_conv_filters=hp.num_conv_filters,
            stem_multiplier=hp.stem_multiplier,
            drop_path_keep_prob=hp.drop_path_keep_prob,
            dense_dropout_keep_prob=hp.dense_dropout_keep_prob,
            use_aux_head=hp.use_aux_head,
            aux_head_weight=hp.aux_head_weight,
            total_training_steps=hp.total_training_steps,
            compute_dtype=hp.compute_dtype,
            remat=hp.remat,
            stem_type=hp.stem_type,
            use_pallas_sep_conv=hp.use_pallas_sep_conv,
        )
        return _NasNetSubnetworkModule(config, input_shape)

    def build_train_optimizer(self, previous_ensemble=None):
        """A factory of `optimizer.Chain` over the module's named
        parameters: clip by the global norm, weight decay on kernels,
        then the rule at `initial_learning_rate`."""
        if self._optimizer_fn is None:
            raise ValueError("builder %r has no optimizer_fn to train with" % self.name)
        hp = self._hparams
        rule = self._optimizer_fn(hp.initial_learning_rate)

        def make(named_parameters):
            return optimizer_lib.Chain(
                [p for _, p in named_parameters],
                rule,
                [_is_kernel(name) for name, _ in named_parameters],
                clip_norm=hp.clip_gradients,
                weight_decay=hp.weight_decay,
            )

        return make

    def build_subnetwork_loss(self, subnetwork, labels, head, context):
        """Label smoothing + aux head + knowledge distillation
        (reference: improve_nas.py:146-188)."""
        hp = self._hparams
        loss = _smoothed_softmax_cross_entropy(subnetwork.logits, labels, hp.label_smoothing)
        aux_logits = (subnetwork.extras or {}).get("aux_logits")
        if aux_logits is not None and hp.use_aux_head:
            loss = loss + hp.aux_head_weight * _smoothed_softmax_cross_entropy(
                aux_logits, labels, hp.label_smoothing
            )
        if context is not None:
            kd = KnowledgeDistillation(hp.knowledge_distillation)
            if kd == KnowledgeDistillation.ADAPTIVE and context.previous_ensemble_logits is not None:
                loss = loss + _distillation_loss(subnetwork.logits, context.previous_ensemble_logits)
            elif kd == KnowledgeDistillation.BORN_AGAIN and context.previous_subnetwork_logits is not None:
                loss = loss + _distillation_loss(subnetwork.logits, context.previous_subnetwork_logits)
        return loss

    def build_subnetwork_report(self) -> Report:
        return Report(
            hparams={
                "num_cells": self._hparams.num_cells,
                "num_conv_filters": self._hparams.num_conv_filters,
                "learning_rate": self._hparams.initial_learning_rate,
            },
            attributes={
                "knowledge_distillation": str(KnowledgeDistillation(self._hparams.knowledge_distillation).value)
            },
            metrics={},
        )

    def to_spec(self) -> Dict[str, Any]:
        return {
            "kind": KIND,
            "hparams": self._hparams.to_dict(),
            "seed": self._seed,
            "num_classes": self._num_classes,
        }

    @classmethod
    def from_spec(cls, spec: Dict[str, Any]) -> "Builder":
        if spec.get("kind") != KIND:
            raise ValueError("not an improve_nas builder spec: %r" % (spec.get("kind"),))
        return cls(
            None,
            Hparams.from_dict(spec["hparams"]),
            seed=spec.get("seed"),
            num_classes=int(spec.get("num_classes", 10)),
        )


def _previous_architecture(previous_ensemble, hparams: Hparams):
    """The last frozen member's (num_cells, num_conv_filters) from its
    `shared` payload, else the hparams' (reference: improve_nas.py:316-325)."""
    num_cells = hparams.num_cells
    num_conv_filters = hparams.num_conv_filters
    if previous_ensemble:
        shared = previous_ensemble.weighted_subnetworks[-1].subnetwork.shared or {}
        num_cells = int(shared.get(_PREVIOUS_NUM_CELLS, num_cells))
        num_conv_filters = int(shared.get(_PREVIOUS_CONV_FILTERS, num_conv_filters))
    return num_cells, num_conv_filters


class Generator(GeneratorBase):
    """The same architecture every iteration (reference: improve_nas.py:217-263)."""

    def __init__(self, optimizer_fn, hparams: Hparams, seed=None, num_classes=10):
        if hparams.num_cells % 3 != 0:
            raise ValueError("num_cells must be a multiple of 3.")
        self._optimizer_fn = optimizer_fn
        self._hparams = hparams
        self._seed = seed
        self._num_classes = num_classes

    def generate_candidates(
        self, previous_ensemble, iteration_number, previous_ensemble_reports, all_reports, config=None
    ) -> List[Builder]:
        return [Builder(self._optimizer_fn, self._hparams, seed=self._seed, num_classes=self._num_classes)]


class DynamicGenerator(Generator):
    """Grows the search space each iteration: one candidate 3 cells deeper
    and one 10 filters wider than the last frozen member (reference:
    improve_nas.py:266-338)."""

    def generate_candidates(
        self, previous_ensemble, iteration_number, previous_ensemble_reports, all_reports, config=None
    ) -> List[Builder]:
        num_cells, num_conv_filters = _previous_architecture(previous_ensemble, self._hparams)

        def make(**changes):
            return Builder(
                self._optimizer_fn, self._hparams.replace(**changes), seed=self._seed, num_classes=self._num_classes
            )

        return [
            make(num_cells=num_cells + 3, num_conv_filters=num_conv_filters),
            make(num_cells=num_cells, num_conv_filters=num_conv_filters + 10),
        ]
