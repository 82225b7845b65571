"""Materialize subnetwork reports over a dataset.

Port of adanet_tpu/core/report_materializer.py, single process: each
trained subnetwork's `Report` metric callables become Python numbers,
averaged over a report dataset, in the `MaterializedReport`s that the
next iteration's `Generator` reads. One no-grad pass a batch runs every
subnetwork's forward, its report metrics and its head loss, and one host
read a batch brings them all back. `collective`: a lockstep pass of
every process of the iteration's process group, each on its slice of
every batch, the sums all-reduced at the end (as the Evaluator's).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch

from adanet_tpu_torch.core.iteration import split_example_weights
from adanet_tpu_torch.distributed import mesh as mesh_lib
from adanet_tpu_torch.ensemble.weighted import full_f32_matmul
from adanet_tpu_torch.subnetwork.report import MaterializedReport, Report
from adanet_tpu_torch.utils.batches import (
    WeightedMeanAccumulator,
    batch_example_count,
    batch_metric_weight,
    read_scalars,
    to_device,
)


class ReportMaterializer:
    """Materializes `Report`s into `MaterializedReport`s.

    Args:
      input_fn: zero-arg callable returning an iterator of (features,
        labels) batches to materialize report metrics over.
      steps: number of batches; None means until exhaustion.
    """

    def __init__(self, input_fn: Callable, steps: Optional[int] = None):
        self._input_fn = input_fn
        self._steps = steps

    @property
    def input_fn(self):
        return self._input_fn

    @property
    def steps(self):
        return self._steps

    def materialize_subnetwork_reports(
        self, iteration, state, included_subnetwork_names: Sequence[str], collective: bool = False
    ) -> List[MaterializedReport]:
        """Every subnetwork's report metrics (and `loss`, its head loss)
        over the dataset, each marked `included_in_final_ensemble` when
        its name is among `included_subnetwork_names`."""
        reports = {
            spec.name: spec.builder.build_subnetwork_report() or Report() for spec in iteration.subnetwork_specs
        }
        weight_key = getattr(iteration, "weight_key", None)

        def batch_metrics(batch):
            features, labels = to_device(batch, iteration.device)
            features, weights = split_example_weights(features, weight_key)
            out = {}
            with full_f32_matmul(), torch.no_grad():
                for spec in iteration.subnetwork_specs:
                    subnetwork = state.subnetworks[spec.name].module(features, training=False)
                    metrics = {name: fn(subnetwork, features, labels) for name, fn in reports[spec.name].metrics.items()}
                    metrics["loss"] = iteration.head.loss(subnetwork.logits, labels, weights)
                    out[spec.name] = metrics
            return out

        # Two accumulators a subnetwork: the user's metric functions get
        # no weights (plain means, combined by example count); the head
        # loss is a weighted mean, combined by total example weight.
        accs = {name: WeightedMeanAccumulator() for name in reports}
        loss_accs = {name: WeightedMeanAccumulator() for name in reports}
        count = 0
        for batch in mesh_lib.lockstep_batches(
            self._input_fn, steps=self._steps, collective=collective, context="ReportMaterializer"
        ):
            n_examples = batch_example_count(batch)
            n_weight = batch_metric_weight(batch, weight_key)
            for name, metrics in read_scalars(batch_metrics(batch)).items():
                loss_accs[name].add({"loss": metrics["loss"]}, n_weight)
                accs[name].add({k: v for k, v in metrics.items() if k != "loss"}, n_examples)
            count += 1
        if count == 0:
            raise ValueError("Report input_fn yielded no batches.")
        if collective:
            for acc in list(accs.values()) + list(loss_accs.values()):
                acc.all_reduce(iteration.process_group, iteration.device)

        included = set(included_subnetwork_names)
        return [
            MaterializedReport(
                iteration_number=iteration.iteration_number,
                name=spec.name,
                hparams=dict(reports[spec.name].hparams),
                attributes=dict(reports[spec.name].attributes),
                metrics={**accs[spec.name].means(), **loss_accs[spec.name].means()},
                included_in_final_ensemble=spec.name in included,
            )
            for spec in iteration.subnetwork_specs
        ]
