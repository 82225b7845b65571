"""improve_nas: NASNet-A subnetworks for AdaNet, forward parts.

Port of research/improve_nas/trainer/improve_nas.py:40-170: `Hparams`,
the `Builder` that turns them into a NASNet-A subnetwork, and the module
that wraps `NasNetA` into the `Subnetwork` contract. Losses, optimizers,
knowledge distillation and the generators come with the training slice.

A builder round-trips through a JSON spec (`to_spec` / `from_spec`), which
is how a published serving generation records how to rebuild its members.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Dict, Optional, Sequence

import torch
import torch.nn as nn

from adanet_tpu_torch.models.nasnet import NasNetA, NasNetConfig
from adanet_tpu_torch.subnetwork.generator import Builder as BuilderBase
from adanet_tpu_torch.subnetwork.generator import Subnetwork

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

    def forward(self, features, training: bool = False) -> Subnetwork:
        images = features["image"] if isinstance(features, dict) else features
        logits, aux_logits, pooled = self.nasnet(images, training=training)
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


class Builder(BuilderBase):
    """Builds a NASNet-A subnetwork (reference: improve_nas.py:60-214).

    `optimizer_fn` is kept for the training slice and unused here.
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
