"""Cross-trial ranking by the complexity-regularized objective F(w).

Port of adanet_tpu/fleet/comparator.py. The AdaNet objective

    F(w) = (1/m) sum_i Phi(sum_j w_j h_j(x_i), y_i)
           + sum_j (lambda * r(h_j) + beta) |w_j|_1

is a principled comparator not just within one search but ACROSS
searches with different lambda/beta, generators, and budgets (PAPER.md
§"What AdaNet is"): the loss term is measured on one shared held-out
set, and the penalty term prices each trial's ensemble by the same
capacity yardstick. Two modes:

- **uniform** (`adanet_lambda`/`adanet_beta` given): the penalty is
  recomputed from every trial's mixture weights and member complexities
  under the COMPARATOR's lambda/beta, so a lambda=0 trial cannot win
  merely by reporting a zero penalty for a huge ensemble.
- **own-objective** (both None): each ensemble's recorded
  `complexity_regularization` (its own lambda/beta) is used — the
  "which search achieved its own objective best" question.

Ties break toward smaller ensembles (fewer members), then by trial id,
so equal-loss trials prefer the cheaper model and ranking is total and
deterministic.

The JAX package stages its scoring program through its compile cache;
the port runs eager (it has no compile cache): the estimator's
`_final_forward_fn` under `torch.no_grad()` with TF32 off, the weighted
members combined by K1 on the card, and the per-batch scalars staged on
the device and read once a pass.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Any, List, Optional, Sequence

import torch

from adanet_tpu_torch.core.iteration import split_example_weights
from adanet_tpu_torch.ensemble.weighted import full_f32_matmul
from adanet_tpu_torch.utils.batches import (
    batch_metric_weight,
    read_scalars,
    to_device,
)


@dataclasses.dataclass(frozen=True)
class Score:
    """One trial's comparator result (lower objective is better)."""

    trial_id: str
    objective: float  # loss + complexity_regularization
    loss: float  # weighted mean head loss on the eval set
    complexity_regularization: float
    num_members: int
    iterations: int
    global_step: int

    def sort_key(self):
        """Total order, best first: finite before non-finite, then
        objective, then FEWER members (the complexity tie-break), then
        trial id for determinism."""
        finite = math.isfinite(self.objective)
        return (
            0 if finite else 1,
            self.objective if finite else 0.0,
            self.num_members,
            self.trial_id,
        )

    def to_json(self) -> dict:
        def _finite(value):
            return float(value) if math.isfinite(value) else None

        return {
            "trial_id": self.trial_id,
            "objective": _finite(self.objective),
            "loss": _finite(self.loss),
            "complexity_regularization": _finite(
                self.complexity_regularization
            ),
            "num_members": int(self.num_members),
            "iterations": int(self.iterations),
            "global_step": int(self.global_step),
        }


def rank(scores: Sequence[Score]) -> List[Score]:
    """Best-first ordering under `Score.sort_key`."""
    return sorted(scores, key=lambda s: s.sort_key())


def _tensor_leaves(tree):
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in _tensor_leaves(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [leaf for item in tree for leaf in _tensor_leaves(item)]
    return [] if tree is None else [torch.as_tensor(tree)]


class Comparator:
    """Scores a trial's current best ensemble on a shared eval stream.

    Args:
      eval_input_fn: zero-arg callable yielding (features, labels)
        batches — the SHARED held-out set every trial is scored on.
      eval_steps: batches per scoring pass (the stream may be infinite).
      adanet_lambda / adanet_beta: uniform-mode penalty strengths; both
        None selects own-objective mode (see module docstring).
    """

    def __init__(
        self,
        eval_input_fn,
        eval_steps: int = 8,
        adanet_lambda: Optional[float] = None,
        adanet_beta: Optional[float] = None,
    ):
        if eval_steps <= 0:
            raise ValueError("eval_steps must be positive.")
        if (adanet_lambda is None) != (adanet_beta is None):
            raise ValueError(
                "Set both of adanet_lambda/adanet_beta (uniform mode) "
                "or neither (own-objective mode)."
            )
        self._eval_input_fn = eval_input_fn
        self._eval_steps = int(eval_steps)
        self._adanet_lambda = (
            None if adanet_lambda is None else float(adanet_lambda)
        )
        self._adanet_beta = (
            None if adanet_beta is None else float(adanet_beta)
        )

    # ------------------------------------------------------------- penalty

    def _penalty(self, ensemble) -> Any:
        """The regularization term, an f32 tensor on the device."""
        members = getattr(ensemble, "weighted_subnetworks", None)
        logits = _tensor_leaves(ensemble.logits)
        device = logits[0].device if logits else torch.device("cpu")
        if self._adanet_lambda is not None and members:
            total = torch.zeros((), dtype=torch.float32, device=device)
            for ws in members:
                l1 = sum(
                    torch.sum(torch.abs(leaf.to(device, torch.float32)))
                    for leaf in _tensor_leaves(ws.weight)
                )
                gamma = (
                    self._adanet_lambda
                    * torch.as_tensor(
                        ws.subnetwork.complexity,
                        dtype=torch.float32,
                        device=device,
                    )
                    + self._adanet_beta
                )
                total = total + gamma * l1
            return total
        recorded = getattr(ensemble, "complexity_regularization", None)
        if recorded is None:
            return torch.zeros((), dtype=torch.float32, device=device)
        return torch.as_tensor(recorded, dtype=torch.float32, device=device)

    # ------------------------------------------------------------- scoring

    def score(self, estimator, trial_id: str) -> Score:
        """F(w) of `estimator`'s current best ensemble, on the
        estimator's device."""
        data = iter(self._eval_input_fn())
        try:
            first = next(data)
        except StopIteration:
            raise ValueError("input_fn yielded no batches.")
        forward, _name = estimator._final_forward_fn(first)
        head = estimator._head
        weight_key = estimator._weight_key
        # Stage per-batch scalars and fetch once after the loop: one
        # host read per scoring pass, not per batch.
        staged = {}
        sizes = []
        with full_f32_matmul(), torch.no_grad():
            batches = zip(range(self._eval_steps), itertools.chain([first], data))
            for index, batch in batches:
                sizes.append(batch_metric_weight(batch, weight_key))
                features, labels = to_device(batch, estimator._device)
                features, weights = split_example_weights(features, weight_key)
                ensemble = forward(features)
                loss = head.loss(ensemble.logits, labels, weights)
                staged[str(index)] = {
                    "loss": loss,
                    "penalty": self._penalty(ensemble),
                }
        host = read_scalars(staged)
        total = sum(sizes) or 1.0
        loss = sum(
            host[str(index)]["loss"] * size
            for index, size in enumerate(sizes)
        ) / total
        # The penalty is a pure function of the params — identical on
        # every batch; take the first.
        penalty = float(host["0"]["penalty"])
        num_members, iterations, global_step = _architecture_facts(
            estimator
        )
        return Score(
            trial_id=str(trial_id),
            objective=loss + penalty,
            loss=loss,
            complexity_regularization=penalty,
            num_members=num_members,
            iterations=iterations,
            global_step=global_step,
        )

def _architecture_facts(estimator):
    """(num_members, completed iterations, global step) from the
    durable record — host-side facts for tie-breaking and reporting."""
    import json
    import os

    from adanet_tpu_torch.core import checkpoint as ckpt_lib

    info = ckpt_lib.read_manifest(estimator.model_dir)
    if info is None or info.iteration_number == 0:
        return 0, 0, 0
    t = info.iteration_number - 1
    path = os.path.join(
        estimator.model_dir, ckpt_lib.architecture_filename(t)
    )
    try:
        with open(path) as f:
            arch = json.load(f)
        members = len(arch.get("subnetworks", []))
    except (OSError, ValueError):
        members = 0
    return members, info.iteration_number, int(info.global_step)


__all__ = ["Comparator", "Score", "rank"]
