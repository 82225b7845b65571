"""Trial specs: one hyperparameter configuration of an AdaNet search.

Port of adanet_tpu/fleet/trial.py. A `TrialSpec` is the unit the fleet
controller schedules: a full search configuration (adanet lambda/beta,
generator/search-space identity, seed, per-iteration step budget) plus
the factories needed to build an `Estimator` for it repeatedly — once
per rung, once per respawn, once for the champion rebuild.

The load-bearing part is the **fingerprint discipline**. Every
ingredient that makes the SAME architecture train to DIFFERENT numbers
must appear in `spec_fingerprint()`, because the shared artifact store
keys frozen payloads by (architecture hash, iteration, spec
fingerprint, env fingerprint) and the fleet's cross-search graft
(`fleet/transfer.py`) reuses a donor's payload iff the fingerprints
agree. The fingerprint is the one the port's Estimator keys its refs by
(`Estimator._store_spec_fingerprint`): `store_spec_extra()` plus the
port's payload format, so a port fleet never grafts a payload written
by the JAX package, whose refs lack that ingredient.

The port's differences: `make_ensembler_optimizer` returns the port's
optimizer factory (`params -> torch.optim.Optimizer`, the form
`ensemble/weighted.py` takes), the mixture weights combine through K1
(`use_fused_combine`; its plain version on the CPU), and the device is
the controller's, passed to `build_estimator` (so `device` is one of
the spec-managed Estimator arguments).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

from adanet_tpu_torch.core.estimator import Estimator
from adanet_tpu_torch.store import keys as store_keys

#: Characters allowed in a trial id (it names model dirs and KV units).
_ID_SAFE = frozenset(
    "abcdefghijklmnopqrstuvwxyz"
    "ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_."
)


@dataclasses.dataclass
class TrialSpec:
    """One search configuration in a fleet.

    Args:
      trial_id: unique, filesystem-safe name ([A-Za-z0-9_.]+).
      make_head: zero-arg factory for the `Head` (fresh per Estimator).
      make_generator: zero-arg factory for the subnetwork `Generator`.
      generator_id: caller-declared identity of the search space —
        everything about the generator that changes trained numbers
        (builder depths/widths, learning rates, dropout, ...) must be
        encoded here, because the generator object itself cannot be
        fingerprinted.
      max_iteration_steps: train steps per iteration.
      random_seed: base seed threaded to the Estimator.
      adanet_lambda / adanet_beta: the complexity-regularization
        strengths of this trial's `ComplexityRegularizedEnsembler`.
      make_ensembler_optimizer: zero-arg factory returning the mixture
        weights' optimizer factory (`params -> torch.optim.Optimizer`;
        None = untrained uniform-average weights). Its identity belongs
        in `extra_spec` if it varies across trials.
      extra_spec: additional JSON-able numeric-relevant configuration
        folded into the spec fingerprint.
      estimator_kwargs: extra `Estimator` kwargs that do NOT change
        numerics (logging cadence, checkpoint cadence, ...). Anything
        numeric-relevant belongs in the explicit fields or `extra_spec`.
    """

    trial_id: str
    make_head: Callable[[], Any]
    make_generator: Callable[[], Any]
    generator_id: str
    max_iteration_steps: int
    random_seed: int = 42
    adanet_lambda: float = 0.0
    adanet_beta: float = 0.0
    make_ensembler_optimizer: Optional[Callable[[], Any]] = None
    extra_spec: Dict[str, Any] = dataclasses.field(default_factory=dict)
    estimator_kwargs: Dict[str, Any] = dataclasses.field(
        default_factory=dict
    )

    #: Fingerprint ingredients owned by the explicit fields; extra_spec
    #: may not shadow them (a shadowed lambda would alias two trials
    #: that train DIFFERENT numbers under one fingerprint — exactly the
    #: corruption the fingerprint exists to preclude). The payload
    #: format is the Estimator's own.
    _DERIVED_SPEC_KEYS = frozenset(
        {
            "adanet_lambda",
            "adanet_beta",
            "generator_id",
            "random_seed",
            "max_iteration_steps",
            "payload_format",
        }
    )

    #: Estimator kwargs managed by the explicit fields / the controller;
    #: estimator_kwargs may not override them (the docstring's
    #: "non-numeric only" rule, enforced: an overridden seed would key
    #: store refs the declared fingerprint never matches).
    _MANAGED_ESTIMATOR_KWARGS = frozenset(
        {
            "head",
            "subnetwork_generator",
            "max_iteration_steps",
            "ensemblers",
            "max_iterations",
            "model_dir",
            "random_seed",
            "artifact_store",
            "replay_config",
            "store_spec_extra",
            "device",
        }
    )

    def __post_init__(self):
        if not self.trial_id or not set(self.trial_id) <= _ID_SAFE:
            raise ValueError(
                "trial_id %r is not filesystem-safe ([A-Za-z0-9_.]+)"
                % (self.trial_id,)
            )
        if self.max_iteration_steps <= 0:
            raise ValueError("max_iteration_steps must be positive.")
        if self.adanet_lambda < 0 or self.adanet_beta < 0:
            raise ValueError("adanet lambda/beta must be >= 0.")
        shadowed = self._DERIVED_SPEC_KEYS & set(self.extra_spec)
        if shadowed:
            raise ValueError(
                "extra_spec may not shadow fingerprint ingredients "
                "derived from the explicit fields: %r"
                % (sorted(shadowed),)
            )
        managed = self._MANAGED_ESTIMATOR_KWARGS & set(
            self.estimator_kwargs
        )
        if managed:
            raise ValueError(
                "estimator_kwargs may not override spec-managed "
                "Estimator arguments %r; use the explicit TrialSpec "
                "fields (numeric-relevant configuration must ride the "
                "fingerprint)" % (sorted(managed),)
            )
        # Fail on construction, not at the first store publication: a
        # non-JSON-able extra would silently break the graft contract.
        store_keys.canonical_json(dict(self.extra_spec))

    # -------------------------------------------------------- fingerprints

    def store_spec_extra(self) -> Dict[str, Any]:
        """The extra fingerprint ingredients this trial declares —
        passed verbatim to `Estimator(store_spec_extra=...)`, which adds
        its payload format, so the trial's refs are keyed exactly as
        `spec_fingerprint` predicts."""
        extra = {
            "adanet_lambda": float(self.adanet_lambda),
            "adanet_beta": float(self.adanet_beta),
            "generator_id": str(self.generator_id),
        }
        extra.update(self.extra_spec)
        return extra

    def spec_fingerprint(self) -> str:
        """The short store spec fingerprint of this configuration.

        Two trials may graft each other's frozen payloads iff these
        agree (`fleet/transfer.py` enforces it).
        """
        extra = self.store_spec_extra()
        extra["payload_format"] = Estimator.STORE_PAYLOAD_FORMAT
        return store_keys.search_spec_fingerprint(
            self.random_seed,
            self.max_iteration_steps,
            extra,
        )

    def summary(self) -> Dict[str, Any]:
        """JSON-able record of this spec (no factories) for fleet.json."""
        return {
            "trial_id": self.trial_id,
            "generator_id": self.generator_id,
            "max_iteration_steps": int(self.max_iteration_steps),
            "random_seed": int(self.random_seed),
            "adanet_lambda": float(self.adanet_lambda),
            "adanet_beta": float(self.adanet_beta),
            "extra_spec": dict(self.extra_spec),
            "spec_fingerprint": self.spec_fingerprint(),
        }

    # ---------------------------------------------------------- estimators

    def build_estimator(
        self,
        model_dir: str,
        artifact_store,
        max_iterations: int,
        replay_config=None,
        device=None,
    ):
        """A fresh `Estimator` for this trial on `device` (the card by
        default), budgeted to `max_iterations` total iterations (a
        rung's cumulative budget), resuming from whatever `model_dir`
        already holds."""
        from adanet_tpu_torch.ensemble.weighted import (
            ComplexityRegularizedEnsembler,
        )

        optimizer = (
            self.make_ensembler_optimizer()
            if self.make_ensembler_optimizer is not None
            else None
        )
        kwargs = dict(
            head=self.make_head(),
            subnetwork_generator=self.make_generator(),
            max_iteration_steps=self.max_iteration_steps,
            ensemblers=[
                ComplexityRegularizedEnsembler(
                    optimizer=optimizer,
                    adanet_lambda=self.adanet_lambda,
                    adanet_beta=self.adanet_beta,
                    use_fused_combine=True,
                )
            ],
            max_iterations=int(max_iterations),
            model_dir=model_dir,
            random_seed=self.random_seed,
            log_every_steps=0,
            artifact_store=artifact_store,
            replay_config=replay_config,
            store_spec_extra=self.store_spec_extra(),
            device=device,
        )
        kwargs.update(self.estimator_kwargs)
        return Estimator(**kwargs)


__all__ = ["TrialSpec"]
