"""Evaluator: score every candidate ensemble over a fixed dataset.

Port of adanet_tpu/core/evaluator.py: between iterations every
candidate's metrics are computed over the evaluation dataset in one pass
(one `Iteration.eval_step` a batch covers all candidates, and one host
read a batch brings the compared metric of every candidate back), and
the best index is chosen by the objective (`np.nanargmin` /
`np.nanargmax`, so an all-NaN slice raises as in JAX).

Collective (data-parallel training across processes): each process
evaluates its own slice of every batch, the streams kept in lockstep by
`distributed.mesh.lockstep_batches`, and the weighted sums and weights
are all-reduced once at the end of the pass, so that every process gets
the global batches' scores and the same winner. (The JAX package
all-gathers each batch's weight, its metrics being global means already.)
"""

from __future__ import annotations

import enum
from typing import Callable, List, Optional

import numpy as np

from adanet_tpu_torch.distributed import mesh as mesh_lib
from adanet_tpu_torch.utils.batches import WeightedMeanAccumulator, batch_metric_weight, read_scalars


class Objective(str, enum.Enum):
    """Direction of the evaluation metric (reference: evaluator.py:36-50)."""

    MINIMIZE = "minimize"
    MAXIMIZE = "maximize"


class Evaluator:
    """Evaluates candidate ensembles on a shared dataset.

    Args:
      input_fn: zero-arg callable returning an iterator of (features,
        labels) batches (the evaluation set).
      steps: number of batches to evaluate; None means until exhaustion.
      metric_name: the metric of the iteration's eval results to compare
        candidates by (default "adanet_loss").
      objective: `Objective` or its string value; MINIMIZE for losses,
        MAXIMIZE for e.g. accuracy.
    """

    def __init__(
        self,
        input_fn: Callable,
        steps: Optional[int] = None,
        metric_name: str = "adanet_loss",
        objective: Objective = Objective.MINIMIZE,
    ):
        self._input_fn = input_fn
        self._steps = steps
        self._metric_name = metric_name
        self._objective = Objective(objective)

    @property
    def input_fn(self):
        return self._input_fn

    @property
    def steps(self):
        return self._steps

    @property
    def metric_name(self) -> str:
        return self._metric_name

    @property
    def objective(self) -> Objective:
        return self._objective

    @property
    def objective_fn(self):
        """np.nanargmin / np.nanargmax (reference: evaluator.py:80-95)."""
        if self._objective == Objective.MINIMIZE:
            return np.nanargmin
        return np.nanargmax

    def evaluate(self, iteration, state, collective: bool = False) -> List[float]:
        """The mean metric of each candidate, in
        `iteration.candidate_names()` order. Batches combine by example
        count, or by total example weight under the iteration's
        `weight_key`, so that a ragged final batch does not skew the
        scores. `collective`: a lockstep pass of every process of the
        iteration's process group (see the module's docstring)."""
        names = iteration.candidate_names()
        acc = WeightedMeanAccumulator()
        for batch in mesh_lib.lockstep_batches(
            self._input_fn, steps=self._steps, collective=collective, context="Evaluator"
        ):
            n = batch_metric_weight(batch, getattr(iteration, "weight_key", None))
            results = iteration.eval_step(state, batch)
            host = read_scalars({"values": {name: results[name][self._metric_name] for name in names}})
            acc.add(host["values"], n)
        if acc.batches == 0:
            raise ValueError("Evaluator input_fn yielded no batches.")
        if collective:
            acc.all_reduce(iteration.process_group, iteration.device)
        means = acc.means()
        return [means[name] for name in names]
