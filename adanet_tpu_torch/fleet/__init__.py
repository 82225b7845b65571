"""Fleet search: a population of AdaNet searches over one shared store.

Port of adanet_tpu/fleet/: the same modules over the port's Estimator,
queue, store and replay, on the card unless the controller is given
`device="cpu"`.

The elastic work-queue scheduler plus the store's zero-retrain warm
starts make running MANY searches nearly free; this package
orchestrates them:

- `trial` — `TrialSpec`: one hyperparameter configuration (adanet
  lambda/beta, generator/search-space identity, seed, step budget) with
  a deterministic spec fingerprint feeding `store/keys.py`, so
  cross-trial artifact reuse is safe by construction.
- `controller` — `FleetController`: the population state machine.
  Successive-halving rungs at iteration boundaries; trials run as
  leased work units on the callable queue, culled trials release
  their capacity back to the queue and survivors immediately re-pack
  onto it; crash-safe durable state (`fleet.json`) with SIGKILL-anywhere
  resume (the `fleet.promote` fault site).
- `comparator` — cross-trial ranking by the complexity-regularized
  AdaNet objective F(w) on one shared eval stream, tie-breaking toward
  smaller ensembles.
- `transfer` — cross-search member grafting: survivors (and the final
  champion rebuild) import proven frozen members from sibling or culled
  trials through `adanet_tpu_torch.replay` and the store's
  (architecture, iteration, spec, env) frozen refs — zero retraining, zero
  kernel launches on graft (the `fleet.graft` fault site).

CLI: `python -m adanet_tpu_torch.tools.fleetctl` (launch / status /
report).
"""

from adanet_tpu_torch.fleet.comparator import Comparator, Score, rank
from adanet_tpu_torch.fleet.controller import (
    FleetController,
    FleetReport,
    TrialRecord,
    load_status,
)
from adanet_tpu_torch.fleet.transfer import GraftPlan, plan_graft
from adanet_tpu_torch.fleet.trial import TrialSpec

__all__ = [
    "Comparator",
    "FleetController",
    "FleetReport",
    "GraftPlan",
    "Score",
    "TrialRecord",
    "TrialSpec",
    "load_status",
    "plan_graft",
    "rank",
]
