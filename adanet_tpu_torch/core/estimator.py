"""The AdaNet Estimator: the user-facing search loop.

Port of adanet_tpu/core/estimator.py, single process:

    while not done:
        generate candidates (user code)      _generate_builders
        train all candidates, step by step   Iteration.train_step
        select the best (EMA, force_grow)    _get_best_ensemble_index
        write architecture-<t>.json and
        the frozen payload, grow from it     _complete_iteration

Batches come from `input_fn`, a zero-argument callable returning an
iterator of (features, labels) numpy batches; it is called again when its
iterator ends, and the batch that sizes an iteration's modules is also
its first training batch, so each global step consumes the same batch as
in the JAX package. Initialisation and dropout draw from a
`torch.Generator` seeded from `random_seed` and the iteration number
(the JAX package's `fold_in`). The search runs on `device` (the card
unless the caller passes "cpu"), with TF32 off.

`model_dir` receives `architecture-<t>.json` (the JAX package's file,
byte for byte) and `frozen-<t>.pt`, the winner's numbers saved with
`torch.save`. Training stops only at the end of an iteration: a
`max_steps` inside one is refused, since going on from there needs the
checkpoint and resume of a later slice. The manifest and its integrity
checks, the generator's reports (`report_materializer`), the artifact
store, serving export, multi-host placement, input prefetch and
profiling come with later slices too.
"""

from __future__ import annotations

import itertools
import logging
import os
import tempfile
from typing import Any, Callable, Dict, Iterator, Optional, Sequence

import numpy as np
import torch

from adanet_tpu_torch._device import resolve_device
from adanet_tpu_torch.core.frozen import FrozenEnsemble
from adanet_tpu_torch.core.iteration import Iteration, IterationBuilder
from adanet_tpu_torch.core.summary import ScopedSummary
from adanet_tpu_torch.ensemble.strategy import GrowStrategy
from adanet_tpu_torch.ensemble.weighted import ComplexityRegularizedEnsembler, full_f32_matmul
from adanet_tpu_torch.robustness import faults as faults_lib
from adanet_tpu_torch.robustness import retry as retry_lib
from adanet_tpu_torch.utils.batches import (
    EVAL_FETCH_WINDOW,
    WeightedMeanAccumulator,
    batch_example_count,
    feature_shape,
    to_device,
)

_LOG = logging.getLogger("adanet_tpu_torch")


def architecture_filename(iteration_number: int) -> str:
    """`<model_dir>/architecture-<t>.json`, the JAX package's name."""
    return "architecture-%d.json" % iteration_number


def frozen_filename(iteration_number: int) -> str:
    return "frozen-%d.pt" % iteration_number


def frozen_to_payload(frozen: FrozenEnsemble) -> Dict[str, Any]:
    """The numbers of a frozen winner, on the CPU, in the layout of the
    JAX package's payload ({} = unset): each member's `state_dict`,
    weight, complexity and `shared`; the ensembler params; the final
    EMA; the name."""

    def cpu(tree):
        if isinstance(tree, dict):
            return {k: cpu(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(cpu(v) for v in tree)
        return tree.detach().cpu() if torch.is_tensor(tree) else tree

    members = []
    for ws in frozen.weighted_subnetworks:
        sub = ws.subnetwork
        members.append(
            {
                "params": cpu(sub.module.state_dict()),
                "weight": {} if ws.weight is None else {"value": cpu(ws.weight)},
                "complexity": float(sub.complexity),
                "shared": {} if sub.shared is None else {"value": sub.shared},
            }
        )
    return {
        "members": members,
        "ensembler_params": {} if frozen.ensembler_params is None else {"value": cpu(frozen.ensembler_params)},
        "final_ema": {} if frozen.final_ema is None else {"value": float(frozen.final_ema)},
        "name": frozen.name,
    }


class Estimator:
    """Drives the AdaNet search: train candidates, select, freeze, grow.

    Args:
      head: a `Head` defining loss, predictions and metrics.
      subnetwork_generator: a `Generator` producing `Builder`s per iteration.
      max_iteration_steps: train steps per iteration (each step consumes
        one batch).
      ensemblers: `Ensembler`s; defaults to an untrained
        `ComplexityRegularizedEnsembler` (uniform average).
      ensemble_strategies: `Strategy`s; defaults to `[GrowStrategy()]`.
      adanet_loss_decay: EMA decay of candidate tracking.
      force_grow: at t>0 never re-select the carried-over previous ensemble.
      max_iterations: stop after this many iterations (None = until
        max_steps).
      model_dir: where the architectures and frozen payloads are written;
        a temp dir when None.
      random_seed: base seed; iteration t draws from a generator seeded
        from (random_seed, t).
      log_every_steps: period of the EMA log and the train summaries
        (0 = never).
      device: where the search runs; the card by default.
    """

    def __init__(
        self,
        head,
        subnetwork_generator,
        max_iteration_steps: int,
        ensemblers: Optional[Sequence[Any]] = None,
        ensemble_strategies: Optional[Sequence[Any]] = None,
        adanet_loss_decay: float = 0.9,
        force_grow: bool = False,
        max_iterations: Optional[int] = None,
        model_dir: Optional[str] = None,
        random_seed: int = 42,
        log_every_steps: int = 100,
        device=None,
    ):
        if max_iteration_steps is None or max_iteration_steps <= 0:
            raise ValueError(
                "max_iteration_steps must be a positive integer, got %r" % (max_iteration_steps,)
            )
        self._device = resolve_device(device)
        self._head = head
        self._generator = subnetwork_generator
        self._max_iteration_steps = int(max_iteration_steps)
        self._ensemblers = list(ensemblers or [ComplexityRegularizedEnsembler()])
        self._strategies = list(ensemble_strategies or [GrowStrategy()])
        self._adanet_loss_decay = float(adanet_loss_decay)
        self._force_grow = bool(force_grow)
        self._max_iterations = max_iterations
        self._model_dir = model_dir or tempfile.mkdtemp(prefix="adanet_tpu_torch_")
        os.makedirs(self._model_dir, exist_ok=True)
        self._random_seed = int(random_seed)
        self._log_every_steps = int(log_every_steps)
        self._summary: Optional[ScopedSummary] = None
        self._iteration_builder = IterationBuilder(
            head=head,
            ensemblers=self._ensemblers,
            ensemble_strategies=self._strategies,
            adanet_loss_decay=self._adanet_loss_decay,
            collect_summaries=self._log_every_steps > 0,
            device=self._device,
        )
        self._global_step = 0
        self._iteration_number = 0
        # The frozen winner of the last completed iteration.
        self._previous: Optional[FrozenEnsemble] = None

    # ------------------------------------------------------------ properties

    @property
    def model_dir(self) -> str:
        return self._model_dir

    def latest_global_step(self) -> int:
        return self._global_step

    def latest_iteration_number(self) -> int:
        return self._iteration_number

    # ----------------------------------------------------------------- train

    def train(
        self,
        input_fn: Callable[[], Iterator],
        max_steps: Optional[int] = None,
        steps: Optional[int] = None,
    ) -> "Estimator":
        """Runs the AdaNet search loop.

        Args:
          input_fn: zero-arg callable returning an iterator of
            (features, labels) batches; re-invoked when exhausted.
          max_steps: total global steps to train to (across iterations
            and train() calls); it must end an iteration, unless
            `max_iterations` stops the search first.
          steps: train this many additional steps instead of max_steps.
        """
        if steps is not None:
            if max_steps is not None:
                raise ValueError("Set at most one of steps and max_steps.")
            max_steps = self._global_step + steps
        self._check_stops_at_an_iteration_end(max_steps)
        with full_f32_matmul():
            self._train_loop(input_fn, max_steps)
        if self._summary is not None:
            self._summary.close()
        return self

    def _check_stops_at_an_iteration_end(self, max_steps):
        """Refuses a `max_steps` inside an iteration (training starts at
        an iteration's first step, and going on from inside one needs
        resume)."""
        if max_steps is None or max_steps <= self._global_step:
            return
        if self._max_iterations is not None:
            last = self._max_iterations * self._max_iteration_steps
            if max_steps >= last:
                return
        if max_steps % self._max_iteration_steps:
            raise ValueError(
                "max_steps=%d falls inside iteration %d (%d steps each): stopping inside an "
                "iteration needs the resume of a later slice"
                % (max_steps, max_steps // self._max_iteration_steps, self._max_iteration_steps)
            )

    def _iteration_generator(self, iteration_number: int) -> torch.Generator:
        """The CPU generator iteration t initialises from: seeded from
        (random_seed, t), the JAX package's fold_in."""
        seed = np.random.SeedSequence([self._random_seed & 0xFFFFFFFF, iteration_number])
        return torch.Generator().manual_seed(int(seed.generate_state(1, np.uint64)[0] >> 1))

    def _train_loop(self, input_fn, max_steps):
        data_iter: Optional[Iterator] = None
        while True:
            t = self._iteration_number
            if self._max_iterations is not None and t >= self._max_iterations:
                _LOG.info("Reached max_iterations=%d.", self._max_iterations)
                break
            if max_steps is not None and self._global_step >= max_steps:
                break

            batch, data_iter = self._next_batch(input_fn, data_iter)
            sample_batch = batch
            data_iter = itertools.chain([batch], data_iter)
            iteration = self._build_iteration(t, sample_batch)
            state = iteration.init_state(self._iteration_generator(t), sample_batch)
            _LOG.info(
                "Starting iteration %d (global step %d): candidates=%s",
                t, self._global_step, iteration.candidate_names(),
            )
            for steps_done in range(1, self._max_iteration_steps + 1):
                batch, data_iter = self._next_batch(input_fn, data_iter)
                state, metrics = iteration.train_step(state, batch)
                self._global_step += 1
                if self._log_every_steps and steps_done % self._log_every_steps == 0:
                    emas = iteration.ema_losses(state)
                    _LOG.info(
                        "iteration %d step %d/%d adanet_loss EMAs: %s",
                        t, steps_done, self._max_iteration_steps,
                        {k: round(v, 6) for k, v in emas.items()},
                    )
                    self._write_train_summaries(iteration, metrics, emas, state)
            self._previous = self._complete_iteration(iteration, state, sample_batch)

    def _next_batch(self, input_fn, data_iter, attempts: int = 3):
        """The next batch, calling `input_fn` again at the end of its
        iterator; a transient data-source failure re-opens the pipeline
        (at most `attempts` pulls)."""
        for attempt in range(attempts):
            if data_iter is None:
                data_iter = iter(input_fn())
            try:
                faults_lib.trip("data.pull")
                return next(data_iter), data_iter
            except StopIteration:
                data_iter = iter(input_fn())
                try:
                    return next(data_iter), data_iter
                except StopIteration:
                    raise ValueError("input_fn yielded no batches.")
            except Exception as exc:
                if attempt == attempts - 1 or not retry_lib.is_transient(exc):
                    raise
                _LOG.warning(
                    "Transient data-source failure (pull attempt %d/%d): %s; re-opening the "
                    "input pipeline.", attempt + 1, attempts, exc,
                )
                data_iter = None
        raise AssertionError("unreachable")  # pragma: no cover

    def _write_train_summaries(self, iteration, metrics, emas, state):
        """Per-candidate summaries under `<model_dir>/ensemble/<name>` and
        `<model_dir>/subnetwork/t<t>_<name>`: losses, the loss EMA, the
        mixture weights as a histogram and the builders' summary tensors."""
        if self._summary is None:
            self._summary = ScopedSummary(self._model_dir)
        step = self._global_step
        host = {k: v.detach().cpu().numpy() if torch.is_tensor(v) else v for k, v in metrics.items()}
        for spec in iteration.ensemble_specs:
            values = {
                "adanet_loss": host.get("adanet_loss/%s" % spec.name),
                "loss": host.get("ensemble_loss/%s" % spec.name),
                "adanet_loss_ema": emas.get(spec.name),
            }
            self._summary.scalars(
                "ensemble", spec.name, {k: float(v) for k, v in values.items() if v is not None}, step
            )
            params = state.ensembles[spec.name].params
            flat = torch.cat([p.detach().reshape(-1) for p in params["weights"] + [params.get("bias")]
                              if p is not None]).cpu().numpy()
            self._summary.histogram("ensemble", spec.name, "mixture_weights", flat, step)
        for spec in iteration.subnetwork_specs:
            scope = "t%d_%s" % (iteration.iteration_number, spec.name)
            scalars = {}
            if "subnetwork_loss/%s" % spec.name in host:
                scalars["loss"] = float(host["subnetwork_loss/%s" % spec.name])
            prefix = "summary/%s/" % spec.name
            for key, value in host.items():
                if not key.startswith(prefix):
                    continue
                arr = np.asarray(value)
                if arr.ndim == 0:
                    scalars[key[len(prefix):]] = float(arr)
                else:
                    self._summary.histogram("subnetwork", scope, key[len(prefix):], arr, step)
            if scalars:
                self._summary.scalars("subnetwork", scope, scalars, step)
        self._summary.flush()

    # ----------------------------------------------------- build and select

    def _generate_builders(self, iteration_number, previous_ensemble):
        # No reports yet: they come with `report_materializer`.
        builders = self._generator.generate_candidates(
            previous_ensemble=previous_ensemble,
            iteration_number=iteration_number,
            previous_ensemble_reports=[],
            all_reports=[],
        )
        if not builders:
            raise ValueError("Generator returned no builders at iteration %d" % iteration_number)
        return builders

    def _build_iteration(self, iteration_number, sample_batch) -> Iteration:
        previous = self._previous
        if iteration_number > 0 and (previous is None or previous.iteration_number != iteration_number - 1):
            raise ValueError(
                "iteration %d needs the frozen winner of iteration %d in this process; "
                "rebuilding it from model_dir comes with resume" % (iteration_number, iteration_number - 1)
            )
        builders = self._generate_builders(iteration_number, previous)
        return self._iteration_builder.build_iteration(
            iteration_number, builders, previous, input_shape=feature_shape(sample_batch[0])
        )

    def _get_best_ensemble_index(self, iteration, state) -> int:
        """The EMA selection, with `force_grow` at t>0."""
        if len(iteration.ensemble_specs) == 1:
            return 0
        exclude_first = self._force_grow and iteration.iteration_number > 0
        return iteration.best_candidate_index(state, exclude_first=exclude_first)

    def _complete_iteration(self, iteration, state, sample_batch) -> FrozenEnsemble:
        """Selects and freezes the winner, writes `architecture-<t>.json`
        and `frozen-<t>.pt`, and moves on to iteration t+1."""
        t = iteration.iteration_number
        best_index = self._get_best_ensemble_index(iteration, state)
        spec = iteration.ensemble_specs[best_index]
        _LOG.info("Iteration %d best ensemble: %s (index %d)", t, spec.name, best_index)
        frozen = iteration.freeze_candidate(state, spec.name, sample_batch)
        frozen.architecture.add_replay_index(best_index)
        frozen.architecture.set_global_step(self._global_step)
        with open(os.path.join(self._model_dir, architecture_filename(t)), "w") as f:
            f.write(frozen.architecture.serialize())
        torch.save(frozen_to_payload(frozen), os.path.join(self._model_dir, frozen_filename(t)))
        if self._summary is not None:
            self._summary.close()
        self._iteration_number = t + 1
        return frozen

    # -------------------------------------------------------------- evaluate

    def evaluate(self, input_fn: Callable[[], Iterator], steps: Optional[int] = None) -> Dict[str, Any]:
        """Evaluates the best ensemble on up to `steps` batches of
        `input_fn`; returns the head's metrics and `loss` averaged by
        example count, with `best_ensemble` and `global_step`."""
        frozen = self._previous
        if frozen is None:
            raise ValueError("No completed iteration to evaluate; call train() first.")
        ensembler = self._iteration_builder._ensembler_by_name(frozen.ensembler_name)
        acc = WeightedMeanAccumulator()
        staged = []

        def drain():
            # One host read for a window of batches' metrics.
            keys = sorted(staged[0][0])
            values = torch.stack([m[k].float() for m, _ in staged for k in keys]).tolist()
            for i, (_, n) in enumerate(staged):
                acc.add(dict(zip(keys, values[i * len(keys):(i + 1) * len(keys)])), n)
            staged.clear()

        with full_f32_matmul(), torch.no_grad():
            for index, batch in enumerate(input_fn()):
                if steps is not None and index >= steps:
                    break
                n = batch_example_count(batch)
                features, labels = to_device(batch, self._device)
                outs = [ws.subnetwork.module(features, training=False) for ws in frozen.weighted_subnetworks]
                ensemble = ensembler.build_ensemble(frozen.ensembler_params, outs)
                metrics = dict(self._head.eval_metrics(ensemble.logits, labels))
                metrics["loss"] = self._head.loss(ensemble.logits, labels)
                staged.append((metrics, n))
                if len(staged) >= EVAL_FETCH_WINDOW:
                    drain()
            if staged:
                drain()
        if not acc.batches:
            raise ValueError("input_fn yielded no batches.")
        result = acc.means()
        result["best_ensemble"] = frozen.name
        result["global_step"] = self._global_step
        return result
