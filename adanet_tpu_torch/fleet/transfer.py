"""Cross-search member grafting over the shared artifact store.

A fleet's trials publish every completed iteration's frozen winner as a
content-addressed `frozen/` ref keyed by (architecture hash, iteration,
spec fingerprint, env fingerprint). `plan_graft` turns that into
transfer: given a recipient trial and the fleet's donor table (sibling
AND culled trials — a culled trial's published members outlive its
submesh), it selects the donors whose spec fingerprint EQUALS the
recipient's, reads their incremental `replay.json` records (partial is
fine — they are written per completed iteration), and returns the
longest recorded prefix as a replay `Config`.

Attached to the recipient's Estimator, the config grafts every
recorded-and-published iteration straight from the store: zero
retraining, zero XLA compiles (`Estimator._try_store_replay`). Safety
is by construction, not convention: equal spec fingerprints mean the
donor's payloads are bit-identical to what the recipient would have
trained itself (`store/keys.py::search_spec_fingerprint`), so a graft
can change WHEN the bytes exist, never WHAT they are. Donors with any
other fingerprint are skipped — there is no "close enough" tier.

The planning seam carries the `fleet.graft` fault site: chaos runs kill
or fail a graft mid-plan, and the controller must degrade to plain
training (an unavailable graft costs compute, never correctness).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import List, Optional, Sequence, Tuple

from adanet_tpu_torch import replay as replay_lib
from adanet_tpu_torch.observability import metrics as metrics_lib
from adanet_tpu_torch.robustness import faults as faults_lib

from adanet_tpu_torch.fleet.trial import TrialSpec

_LOG = logging.getLogger("adanet_tpu_torch")


@dataclasses.dataclass(frozen=True)
class GraftPlan:
    """A replay config sourced from a compatible donor search."""

    config: replay_lib.Config
    donor_id: str
    donor_dir: str
    iterations: int  # recorded (graftable) iterations in `config`


def plan_graft(
    recipient: TrialSpec,
    donors: Sequence[Tuple[TrialSpec, str]],
    exclude_dir: Optional[str] = None,
) -> Optional[GraftPlan]:
    """The longest graftable replay prefix for `recipient`.

    Args:
      recipient: the trial about to (re)launch.
      donors: (spec, model_dir) pairs — siblings, culled trials, and
        prior incarnations of the recipient itself.
      exclude_dir: a model dir to skip (the recipient's own target dir:
        resuming from its checkpoint needs no graft).

    Returns None when no fingerprint-compatible donor recorded any
    iteration. Raises nothing of its own, but the `fleet.graft` fault
    site fires here — callers treat ANY exception as "graft
    unavailable" and launch without one.
    """
    fingerprint = recipient.spec_fingerprint()
    candidates: List[Tuple[TrialSpec, str]] = [
        (spec, model_dir)
        for spec, model_dir in donors
        if model_dir != exclude_dir
        and spec.spec_fingerprint() == fingerprint
    ]
    if not candidates:
        return None
    # An attempt = planning over at least one fingerprint-compatible
    # donor; hits (`fleet.graft.hits`) are booked by the controller as
    # iterations actually grafted from the store.
    metrics_lib.registry().counter("fleet.graft.attempts").inc()
    # The graft seam: arming `fleet.graft` with error makes planning
    # fail (degrade to training); kill reproduces a controller death
    # mid-transfer.
    faults_lib.trip("fleet.graft")
    best: Optional[GraftPlan] = None
    for spec, model_dir in candidates:
        config = replay_lib.load_partial(model_dir)
        # Only iterations with a recorded architecture hash are
        # graftable through the store; indices past the hashes would
        # replay the SELECTION but still retrain, which is valid but
        # not a transfer — keep the plan honest.
        graftable = min(
            config.num_iterations, len(config.architecture_hashes)
        )
        if graftable == 0:
            continue
        if best is None or graftable > best.iterations:
            best = GraftPlan(
                config=replay_lib.Config(
                    best_ensemble_indices=(
                        config.best_ensemble_indices[:graftable]
                    ),
                    architecture_hashes=(
                        config.architecture_hashes[:graftable]
                    ),
                ),
                donor_id=spec.trial_id,
                donor_dir=model_dir,
                iterations=graftable,
            )
    if best is not None:
        _LOG.info(
            "Graft plan for trial %s: %d iteration(s) from donor %s "
            "(spec %s).",
            recipient.trial_id,
            best.iterations,
            best.donor_id,
            fingerprint,
        )
    return best


__all__ = ["GraftPlan", "plan_graft"]
