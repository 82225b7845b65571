"""Reports: search-space feedback passed between iterations.

Analogue of the reference report containers
(reference: adanet/subnetwork/report.py:30-210). A `Builder` can emit a
`Report` of hyperparameters, attributes, and metric functions; the engine
materializes the metrics over a report dataset into python primitives
(`MaterializedReport`) and feeds them back to the `Generator` on later
iterations (reference: adanet/core/report_materializer.py,
adanet/core/report_accessor.py).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Mapping, Optional

_PRIMITIVES = (bool, int, float, str)


def _validate_primitive_dict(name: str, d: Mapping[str, Any]) -> Dict[str, Any]:
    out = {}
    for key, value in dict(d).items():
        if isinstance(value, _PRIMITIVES):
            out[key] = value
        else:
            raise ValueError(
                "%s[%r] must be a python primitive (bool/int/float/str), "
                "got %r" % (name, key, type(value))
            )
    return out


@dataclasses.dataclass(frozen=True)
class Report:
    """What a `Builder` reports about itself to future iterations.

    Analogue of reference `adanet.subnetwork.Report`
    (reference: adanet/subnetwork/report.py:30-133). In the reference,
    `metrics` are graph tensors materialized by a session loop; here each
    metric is a callable `fn(subnetwork, features, labels) -> scalar` that the
    engine evaluates (jitted) over the report dataset and averages.

    Attributes:
      hparams: dict of python-primitive hyperparameters.
      attributes: dict of python-primitive attributes (e.g. derived stats).
      metrics: dict of metric callables evaluated over the report dataset.
    """

    hparams: Dict[str, Any] = dataclasses.field(default_factory=dict)
    attributes: Dict[str, Any] = dataclasses.field(default_factory=dict)
    metrics: Dict[str, Callable] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        object.__setattr__(
            self, "hparams", _validate_primitive_dict("hparams", self.hparams)
        )
        object.__setattr__(
            self,
            "attributes",
            _validate_primitive_dict("attributes", self.attributes),
        )


@dataclasses.dataclass(frozen=True)
class MaterializedReport:
    """A `Report` with metrics materialized to python primitives.

    Analogue of reference `adanet.subnetwork.MaterializedReport`
    (reference: adanet/subnetwork/report.py:136-210).
    """

    iteration_number: int
    name: str
    hparams: Dict[str, Any] = dataclasses.field(default_factory=dict)
    attributes: Dict[str, Any] = dataclasses.field(default_factory=dict)
    metrics: Dict[str, Any] = dataclasses.field(default_factory=dict)
    included_in_final_ensemble: bool = False

    def to_json(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, obj: Mapping[str, Any]) -> "MaterializedReport":
        return cls(
            iteration_number=int(obj["iteration_number"]),
            name=str(obj["name"]),
            hparams=dict(obj.get("hparams", {})),
            attributes=dict(obj.get("attributes", {})),
            metrics=dict(obj.get("metrics", {})),
            included_in_final_ensemble=bool(
                obj.get("included_in_final_ensemble", False)
            ),
        )
