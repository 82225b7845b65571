"""The AdaNet Estimator: the user-facing search loop.

Port of adanet_tpu/core/estimator.py, single process:

    fsck the model dir, read the manifest     integrity.fsck
    while not done:
        generate candidates (user code)      _generate_builders
        rebuild the previous winner from
        disk on a fresh start                _rebuild_previous_ensemble
        init, or restore the mid-iteration
        state                                _init_or_restore_state
        train all candidates, a window of
        iterations_per_loop steps at a time  Iteration.train_steps
        checkpoint when a window crosses save_checkpoint_steps, and on a
        stop inside the iteration (max_steps,
        SIGTERM)                             _save_iteration_state
        select the best (EMA or Evaluator,
        force_grow)                          _get_best_ensemble_index
        write candidate-metrics-<t>.json,
        iteration-final-<t>.pt (kept states),
        architecture-<t>.json, the frozen
        payload, the reports and the
        manifest                             _complete_iteration

Batches come from `input_fn`, a zero-argument callable returning an
iterator of (features, labels) numpy batches; it is called again when its
iterator ends, and the batch that sizes an iteration's modules is also
its first training batch, so each global step consumes the same batch as
in the JAX package. A resumed process calls `input_fn` afresh, as the
JAX package does. Initialisation and dropout draw from a
`torch.Generator` seeded from `random_seed` and the iteration number
(the JAX package's `fold_in`); the dropout generator's state is part of
the checkpoint. The search runs on `device` (the card unless the caller
passes "cpu"), with TF32 off.

The JAX package's training-throughput configuration: a window of
`iterations_per_loop` steps runs back to back (`Iteration.train_steps`;
a step reads nothing on the host) and the host reads the subnetworks'
counters once a window, to log a quarantine; the window is clipped by
the iteration's end and by `max_steps` (a ragged window, batches of
different shapes, needs nothing more: its steps run one after another,
as every window's do), logs and checkpoints fire when a
window crosses their interval, and the stop checks (SIGTERM,
`max_steps`) run once a window. `step_compute_dtype` casts the float
features at each step's boundary (`utils/precision.py`);
`prefetch_buffer` pulls batches on a worker thread and
`prefetch_to_device` also copies them to the device there
(`utils/prefetch.py`); the prefetchers are closed when their stream ends
and when `train` returns, at a stop, on SIGTERM or on an error.
`profile_dir` traces each iteration's first `profile_steps` steps with
`torch.profiler` (`<profile_dir>/iteration_<t>/trace.json`), `debug`
checks every batch for non-finite floats on the host, `metric_fn` adds
metrics to `evaluate`, and `predict(on_cpu=True)` predicts on the CPU
when the caller asks for it.

`model_dir` holds the JAX package's checkpoint layout
(`core/checkpoint.py`): `architecture-<t>.json` (the JAX package's file,
byte for byte), `frozen-<t>.pt`, `ckpt-<step>.pt` and the manifest
`checkpoint.json`, every payload written atomically beside its digest.
A search stopped anywhere (`max_steps`, SIGTERM, a crash) resumes from
`model_dir` in a fresh process.

Selection and feedback, single process: an `evaluator` chooses each
iteration's winner on held-out data (`force_grow` excludes the
carried-over ensemble); `candidate-metrics-<t>.json` records every
candidate's losses, quarantine flag, Evaluator value and the winner
after every iteration (`candidate_metrics`), also as `ensemble/<name>/
eval` summaries; a `report_materializer` writes the subnetworks'
reports to `<report_dir>/iteration_reports.json`, which the generator
reads at later iterations; `keep_candidate_states` retains every
candidate's final state (`iteration-final-<t>.pt`) for
`evaluate_all_candidates`; a `weight_key` names the features' example
weight column, which every loss and metric is weighted by. Replay, the
artifact store, serving export and multi-host placement come with later
slices.
"""

from __future__ import annotations

import copy
import inspect
import itertools
import logging
import math
import os
import signal
import tempfile
import threading
from typing import Any, Callable, Dict, Iterator, Optional, Sequence

import numpy as np
import torch

from adanet_tpu_torch._device import resolve_device
from adanet_tpu_torch.core import candidate as candidate_lib
from adanet_tpu_torch.core import checkpoint as ckpt_lib
from adanet_tpu_torch.core import iteration as iteration_lib
from adanet_tpu_torch.core.architecture import Architecture
from adanet_tpu_torch.core.evaluator import Evaluator
from adanet_tpu_torch.core.frozen import FrozenEnsemble, FrozenWeightedSubnetwork, rebuild_subnetwork
from adanet_tpu_torch.core.iteration import Iteration, IterationBuilder, split_example_weights
from adanet_tpu_torch.core.report_accessor import ReportAccessor
from adanet_tpu_torch.core.report_materializer import ReportMaterializer
from adanet_tpu_torch.core.summary import ScopedSummary
from adanet_tpu_torch.ensemble.strategy import GrowStrategy
from adanet_tpu_torch.ensemble.weighted import ComplexityRegularizedEnsembler, full_f32_matmul
from adanet_tpu_torch.robustness import faults as faults_lib
from adanet_tpu_torch.robustness import integrity
from adanet_tpu_torch.robustness import retry as retry_lib
from adanet_tpu_torch.utils import precision
from adanet_tpu_torch.utils.trees import tree_leaves
from adanet_tpu_torch.utils.batches import (
    EVAL_FETCH_WINDOW,
    WeightedMeanAccumulator,
    batch_example_count,
    batch_metric_weight,
    feature_shape,
    read_scalars,
    to_device,
)

_LOG = logging.getLogger("adanet_tpu_torch")


def _crossed(prev_step: int, step: int, interval: int) -> bool:
    """True when (prev_step, step] holds a multiple of `interval` (a
    window advances the step by more than 1)."""
    return step // interval > prev_step // interval


def _check_batch_finite(batch) -> None:
    """Raises `FloatingPointError` when a float leaf of the host batch is
    not finite (`debug=True`)."""
    for leaf in tree_leaves(batch):
        if torch.is_tensor(leaf):
            leaf = leaf.detach().float().cpu().numpy() if leaf.is_floating_point() else None
        if leaf is None or not np.issubdtype(np.asarray(leaf).dtype, np.floating):
            continue
        if not np.all(np.isfinite(leaf)):
            raise FloatingPointError("Non-finite values in an input batch (debug=True).")


def _checked(source):
    for batch in source:
        _check_batch_finite(batch)
        yield batch


class Estimator:
    """Drives the AdaNet search: train candidates, select, freeze, grow.

    Args:
      head: a `Head` defining loss, predictions and metrics.
      subnetwork_generator: a `Generator` producing `Builder`s per
        iteration; it must be deterministic, since a fresh process
        replays it to rebuild the previous winners.
      max_iteration_steps: train steps per iteration (each step consumes
        one batch).
      ensemblers: `Ensembler`s; defaults to an untrained
        `ComplexityRegularizedEnsembler` (uniform average).
      ensemble_strategies: `Strategy`s; defaults to `[GrowStrategy()]`.
      evaluator: an `Evaluator` scoring the candidates on held-out data
        at each iteration's end; without one the training-loss EMAs
        decide.
      report_materializer: a `ReportMaterializer` whose reports the
        generator gets at later iterations.
      adanet_loss_decay: EMA decay of candidate tracking.
      force_grow: at t>0 never re-select the carried-over previous ensemble.
      max_iterations: stop after this many iterations (None = until
        max_steps).
      model_dir: where the checkpoints are written and read; a temp dir
        when None.
      report_dir: where the reports are kept; `<model_dir>/report` by
        default.
      random_seed: base seed; iteration t draws from a generator seeded
        from (random_seed, t).
      save_checkpoint_steps: save the mid-iteration state every this many
        steps of an iteration (None = only when training stops inside an
        iteration).
      log_every_steps: period of the EMA log and the train summaries
        (0 = never).
      checkpoint_on_sigterm: on SIGTERM, finish the current step, save
        the mid-iteration state and return from `train`; a second SIGTERM
        goes to the previous handler. Installed on the main thread only.
      device: where the search runs; the card by default.
      iterations_per_loop: steps a window (see the module's docstring).
      step_compute_dtype: e.g. "bfloat16": every train step casts its
        float features to it; parameters, optimizer state, statistics,
        labels, logits and losses stay f32. None trains in the input
        dtype.
      prefetch_buffer: batches pulled ahead on a worker thread (0: none);
        order and results are unchanged.
      prefetch_to_device: with `prefetch_buffer`, the worker also copies
        each batch to `device` (pinned memory and a side stream on the
        card).
      debug: check every training and evaluation batch for non-finite
        floats before it is used.
      metric_fn: `metric_fn(logits, labels) -> {name: 0-d tensor}`, extra
        metrics of `evaluate`, averaged by example count; with a
        `weight_key`, the form `metric_fn(logits, labels, weights)` gets
        the weights and is averaged by total example weight.
      profile_dir: trace each iteration's first `profile_steps` steps
        with torch.profiler into `<profile_dir>/iteration_<t>/`.
      weight_key: the key of the per-example weight column in the
        features mapping; the models never see it, and it weights every
        head loss and metric (training, Evaluator, reports, `evaluate`).
      keep_candidate_states: keep every candidate's final state when an
        iteration completes (`iteration-final-<t>.pt`), so that
        `evaluate_all_candidates` works after the winner is frozen.
    """

    def __init__(
        self,
        head,
        subnetwork_generator,
        max_iteration_steps: int,
        ensemblers: Optional[Sequence[Any]] = None,
        ensemble_strategies: Optional[Sequence[Any]] = None,
        evaluator: Optional[Evaluator] = None,
        report_materializer: Optional[ReportMaterializer] = None,
        adanet_loss_decay: float = 0.9,
        force_grow: bool = False,
        max_iterations: Optional[int] = None,
        model_dir: Optional[str] = None,
        report_dir: Optional[str] = None,
        random_seed: int = 42,
        save_checkpoint_steps: Optional[int] = None,
        log_every_steps: int = 100,
        checkpoint_on_sigterm: bool = True,
        device=None,
        iterations_per_loop: int = 1,
        step_compute_dtype=None,
        prefetch_buffer: int = 0,
        prefetch_to_device: bool = False,
        debug: bool = False,
        metric_fn: Optional[Callable] = None,
        profile_dir: Optional[str] = None,
        profile_steps: int = 5,
        weight_key: Optional[str] = None,
        keep_candidate_states: bool = False,
    ):
        if max_iteration_steps is None or max_iteration_steps <= 0:
            raise ValueError(
                "max_iteration_steps must be a positive integer, got %r" % (max_iteration_steps,)
            )
        if iterations_per_loop < 1:
            raise ValueError("iterations_per_loop must be >= 1.")
        if prefetch_buffer < 0:
            raise ValueError("prefetch_buffer must be >= 0.")
        self._device = resolve_device(device)
        self._iterations_per_loop = int(iterations_per_loop)
        self._prefetch_buffer = int(prefetch_buffer)
        self._prefetch_to_device = bool(prefetch_to_device)
        self._open_prefetchers: list = []
        self._debug = bool(debug)
        self._metric_fn = metric_fn
        self._profile_dir = profile_dir
        self._profile_steps = int(profile_steps)
        self._head = head
        self._generator = subnetwork_generator
        self._max_iteration_steps = int(max_iteration_steps)
        self._ensemblers = list(ensemblers or [ComplexityRegularizedEnsembler()])
        self._strategies = list(ensemble_strategies or [GrowStrategy()])
        self._evaluator = evaluator
        self._report_materializer = report_materializer
        self._weight_key = weight_key
        self._keep_candidate_states = bool(keep_candidate_states)
        # The Evaluator's values of the last selection, for the
        # candidate-metrics record (None without an Evaluator).
        self._last_selection_values: Optional[list] = None
        self._adanet_loss_decay = float(adanet_loss_decay)
        self._force_grow = bool(force_grow)
        self._max_iterations = max_iterations
        self._model_dir = model_dir or tempfile.mkdtemp(prefix="adanet_tpu_torch_")
        os.makedirs(self._model_dir, exist_ok=True)
        self._report_accessor = ReportAccessor(report_dir or os.path.join(self._model_dir, "report"))
        self._random_seed = int(random_seed)
        self._save_checkpoint_steps = save_checkpoint_steps
        self._log_every_steps = int(log_every_steps)
        self._checkpoint_on_sigterm = bool(checkpoint_on_sigterm)
        self._stop_requested = False
        self._summary: Optional[ScopedSummary] = None
        self._step_compute_dtype = precision.resolve_dtype(step_compute_dtype)
        self._iteration_builder = self._make_iteration_builder(self._device)
        # The winner of the last iteration this train() call completed;
        # the first iteration of a call rebuilds its previous from disk.
        self._previous: Optional[FrozenEnsemble] = None

    def _make_iteration_builder(self, device) -> IterationBuilder:
        return IterationBuilder(
            head=self._head,
            ensemblers=self._ensemblers,
            ensemble_strategies=self._strategies,
            adanet_loss_decay=self._adanet_loss_decay,
            collect_summaries=self._log_every_steps > 0,
            device=device,
            step_compute_dtype=self._step_compute_dtype,
            weight_key=self._weight_key,
        )

    def _model_features(self, features):
        """`features` without the weight column, if any."""
        return split_example_weights(features, self._weight_key, require=False)[0]

    # ------------------------------------------------------------ properties

    @property
    def model_dir(self) -> str:
        return self._model_dir

    def latest_global_step(self) -> int:
        info = ckpt_lib.read_manifest(self._model_dir)
        return info.global_step if info else 0

    def latest_iteration_number(self) -> int:
        info = ckpt_lib.read_manifest(self._model_dir)
        return info.iteration_number if info else 0

    # ----------------------------------------------------------------- train

    def train(
        self,
        input_fn: Callable[[], Iterator],
        max_steps: Optional[int] = None,
        steps: Optional[int] = None,
    ) -> "Estimator":
        """Runs the AdaNet search loop from where `model_dir` stands.

        Args:
          input_fn: zero-arg callable returning an iterator of
            (features, labels) batches; re-invoked when exhausted.
          max_steps: total global steps to train to (across iterations,
            train() calls and processes); training stops there, inside
            an iteration or not, with the state checkpointed.
          steps: train this many additional steps instead of max_steps.
        """
        if steps is not None:
            if max_steps is not None:
                raise ValueError("Set at most one of steps and max_steps.")
            max_steps = self.latest_global_step() + steps
        # Verify and heal before trusting any bytes: corrupt files are
        # quarantined and the manifest rolls back to the newest intact
        # generation.
        heal = integrity.fsck(self._model_dir, repair=True)
        if heal.rolled_back_to_iteration is not None:
            log = _LOG.error if heal.verdict == "unrecoverable" else _LOG.warning
            log(
                "Checkpoint %s: rolled back to iteration %d (global step %s); quarantined %s.",
                heal.verdict, heal.rolled_back_to_iteration, heal.rolled_back_global_step,
                heal.quarantined or heal.issues,
            )
        info = heal.info or ckpt_lib.CheckpointInfo()
        self._stop_requested = False
        previous_handler = None
        handler_installed = False
        if self._checkpoint_on_sigterm and threading.current_thread() is threading.main_thread():

            def handler(signum, frame):
                if self._stop_requested:
                    # A second signal goes to the previous disposition, so
                    # that a stuck run can still be killed.
                    signal.signal(signal.SIGTERM, previous_handler if previous_handler is not None else signal.SIG_DFL)
                    if callable(previous_handler):
                        previous_handler(signum, frame)
                    else:
                        raise SystemExit(128 + signum)
                    return
                _LOG.warning("SIGTERM received: checkpointing at the next step boundary, then stopping.")
                self._stop_requested = True

            previous_handler = signal.signal(signal.SIGTERM, handler)
            handler_installed = True
        self._previous = None
        try:
            with full_f32_matmul():
                self._train_loop(input_fn, max_steps, info)
        finally:
            if handler_installed:
                signal.signal(signal.SIGTERM, previous_handler if previous_handler is not None else signal.SIG_DFL)
            # A worker abandoned mid-stream would park on its queue, with
            # its batches, until the process exits.
            self._close_prefetchers()
            self._previous = None
            if self._summary is not None:
                self._summary.close()
        return self

    def _iteration_generator(self, iteration_number: int) -> torch.Generator:
        """The CPU generator iteration t initialises from: seeded from
        (random_seed, t), the JAX package's fold_in."""
        seed = np.random.SeedSequence([self._random_seed & 0xFFFFFFFF, iteration_number])
        return torch.Generator().manual_seed(int(seed.generate_state(1, np.uint64)[0] >> 1))

    def _train_loop(self, input_fn, max_steps, info):
        data_iter: Optional[Iterator] = None
        while True:
            t = info.iteration_number
            if self._stop_requested:
                break
            if self._max_iterations is not None and t >= self._max_iterations:
                _LOG.info("Reached max_iterations=%d.", self._max_iterations)
                break
            if max_steps is not None and info.global_step >= max_steps:
                break

            batch, data_iter = self._next_batch(input_fn, data_iter)
            sample_batch = batch
            data_iter = itertools.chain([batch], data_iter)
            iteration = self._build_iteration(t, sample_batch)
            state = self._init_or_restore_state(iteration, sample_batch, info)
            steps_done = state.iteration_step
            _LOG.info(
                "Starting iteration %d at iteration_step %d (global step %d): candidates=%s",
                t, steps_done, info.global_step, iteration.candidate_names(),
            )
            profile = None
            profile_stop_at = None
            dead: set = set()
            while (
                steps_done < self._max_iteration_steps
                and not self._stop_requested
                and (max_steps is None or info.global_step < max_steps)
            ):
                if self._profile_dir and profile_stop_at is None:
                    profile = self._start_profile()
                    profile_stop_at = steps_done + self._profile_steps
                budget = self._max_iteration_steps - steps_done
                if max_steps is not None:
                    budget = min(budget, max_steps - info.global_step)
                loop_size = min(self._iterations_per_loop, budget)
                batches = []
                for _ in range(loop_size):
                    batch, data_iter = self._next_batch(input_fn, data_iter)
                    batches.append(batch)
                state, metrics = iteration.train_steps(state, batches)
                prev_steps_done = steps_done
                steps_done += loop_size
                info.global_step += loop_size
                self._log_quarantines(iteration, state, dead)
                if profile is not None and steps_done >= profile_stop_at:
                    self._stop_profile(profile, t)
                    profile = None
                if self._log_every_steps and _crossed(prev_steps_done, steps_done, self._log_every_steps):
                    emas = iteration.ema_losses(state)
                    _LOG.info(
                        "iteration %d step %d/%d adanet_loss EMAs: %s",
                        t, steps_done, self._max_iteration_steps,
                        {k: round(v, 6) for k, v in emas.items()},
                    )
                    self._write_train_summaries(iteration, metrics, emas, state, info.global_step)
                if self._save_checkpoint_steps and _crossed(
                    prev_steps_done, steps_done, self._save_checkpoint_steps
                ):
                    self._save_iteration_state(info, t, state)
            if profile is not None:
                self._stop_profile(profile, t)
            if steps_done < self._max_iteration_steps:
                # Stopped inside the iteration (max_steps or SIGTERM):
                # persist the state; a fresh process resumes from here.
                self._save_iteration_state(info, t, state)
                if self._stop_requested:
                    _LOG.warning(
                        "Stopped by SIGTERM at global step %d (iteration %d, step %d); state checkpointed.",
                        info.global_step, t, steps_done,
                    )
                break
            self._previous = self._complete_iteration(iteration, state, sample_batch, info)

    @staticmethod
    def _log_quarantines(iteration, state, dead: set) -> None:
        """The window's one host read: the subnetworks' counters; a
        subnetwork that went non-finite in the window is logged once."""
        for name, (_, is_dead) in iteration.host_counters(state).items():
            if is_dead and name not in dead:
                dead.add(name)
                _LOG.warning("Subnetwork %s had a non-finite loss: quarantined, its updates skipped.", name)

    def _start_profile(self):
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self._device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        profile = torch.profiler.profile(activities=activities)
        profile.start()
        return profile

    def _stop_profile(self, profile, iteration_number: int) -> None:
        if self._device.type == "cuda":
            torch.cuda.synchronize(self._device)
        profile.stop()
        out = os.path.join(self._profile_dir, "iteration_%d" % iteration_number)
        os.makedirs(out, exist_ok=True)
        profile.export_chrome_trace(os.path.join(out, "trace.json"))

    def _make_train_iter(self, input_fn):
        """A fresh iterator over input_fn(), checked (`debug`) and
        prefetched when configured."""
        data_iter = iter(input_fn())
        if self._debug:
            data_iter = _checked(data_iter)
        if self._prefetch_buffer > 0:
            from adanet_tpu_torch.utils.prefetch import DevicePrefetchIterator, PrefetchIterator

            if self._prefetch_to_device:
                data_iter = DevicePrefetchIterator(data_iter, buffer_size=self._prefetch_buffer, device=self._device)
            else:
                data_iter = PrefetchIterator(data_iter, buffer_size=self._prefetch_buffer)
            self._open_prefetchers.append(data_iter)
        return data_iter

    def _close_prefetchers(self) -> None:
        for prefetcher in self._open_prefetchers:
            prefetcher.close()
        self._open_prefetchers.clear()

    def _next_batch(self, input_fn, data_iter, attempts: int = 3):
        """The next batch, calling `input_fn` again at the end of its
        iterator; a transient data-source failure re-opens the pipeline
        (at most `attempts` pulls)."""
        for attempt in range(attempts):
            if data_iter is None:
                data_iter = self._make_train_iter(input_fn)
            try:
                faults_lib.trip("data.pull")
                return next(data_iter), data_iter
            except StopIteration:
                # The stream ended: its prefetcher (the only open one)
                # goes before the next epoch's opens.
                self._close_prefetchers()
                data_iter = self._make_train_iter(input_fn)
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
                self._close_prefetchers()
                data_iter = None
        raise AssertionError("unreachable")  # pragma: no cover

    def _write_train_summaries(self, iteration, metrics, emas, state, step):
        """Per-candidate summaries under `<model_dir>/ensemble/<name>` and
        `<model_dir>/subnetwork/t<t>_<name>`: losses, the loss EMA, the
        mixture weights as a histogram and the builders' summary tensors."""
        if self._summary is None:
            self._summary = ScopedSummary(self._model_dir)
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
            params = iteration_lib._params_list(state.ensembles[spec.name].params)
            if params:
                flat = torch.cat([p.detach().reshape(-1) for p in params]).cpu().numpy()
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

    def _reports_for_iteration(self, iteration_number: int):
        """(previous_ensemble_reports, all_reports) for the generator:
        the reports of iteration t-1 marked `included_in_final_ensemble`,
        and every report of iterations before t."""
        per_iteration = self._report_accessor.read_iteration_reports()[:iteration_number]
        all_reports = [r for reports in per_iteration for r in reports]
        previous = [r for r in per_iteration[-1] if r.included_in_final_ensemble] if per_iteration else []
        return previous, all_reports

    def _generate_builders(self, iteration_number, previous_ensemble):
        previous_reports, all_reports = self._reports_for_iteration(iteration_number)
        builders = self._generator.generate_candidates(
            previous_ensemble=previous_ensemble,
            iteration_number=iteration_number,
            previous_ensemble_reports=previous_reports,
            all_reports=all_reports,
        )
        if not builders:
            raise ValueError("Generator returned no builders at iteration %d" % iteration_number)
        return builders

    def _build_iteration(self, iteration_number, sample_batch) -> Iteration:
        previous = self._previous
        if previous is None or previous.iteration_number != iteration_number - 1:
            previous = self._rebuild_previous_ensemble(iteration_number, sample_batch)
        builders = self._generate_builders(iteration_number, previous)
        return self._iteration_builder.build_iteration(
            iteration_number, builders, previous, input_shape=feature_shape(self._model_features(sample_batch[0]))
        )

    def _rebuild_previous_ensemble(self, iteration_number: int, sample_batch) -> Optional[FrozenEnsemble]:
        """Rebuilds the frozen winner of t-1 from disk: replays the
        generator for each past iteration, rebuilds the winner's new
        members' modules and loads the frozen payload's numbers onto
        them (reference: estimator.py:1785-1882)."""
        prev: Optional[FrozenEnsemble] = None
        input_shape = feature_shape(self._model_features(sample_batch[0]))
        for i in range(iteration_number):
            with open(os.path.join(self._model_dir, ckpt_lib.architecture_filename(i))) as f:
                arch = Architecture.deserialize(f.read())
            builders = {b.name: b for b in self._generate_builders(i, prev)}
            kept = {(s.iteration_number, s.name): s for s in prev.subnetworks} if prev is not None else {}
            weighted = []
            for member_iter, name in arch.subnetworks:
                if member_iter == i:
                    if name not in builders:
                        raise ValueError(
                            "Cannot rebuild iteration %d: generator did not produce builder %r (it must be "
                            "deterministic)." % (i, name)
                        )
                    sub = rebuild_subnetwork(builders[name], i, self._head.logits_dimension, prev, input_shape)
                elif (member_iter, name) in kept:
                    sub = kept[(member_iter, name)]
                else:
                    raise ValueError(
                        "Architecture %d references member %s not in the rebuilt previous ensemble."
                        % (i, (member_iter, name))
                    )
                weighted.append(FrozenWeightedSubnetwork(subnetwork=sub))
            frozen = FrozenEnsemble(
                name="t{}_{}_{}".format(i, arch.ensemble_candidate_name, arch.ensembler_name),
                iteration_number=i,
                weighted_subnetworks=weighted,
                ensembler_name=arch.ensembler_name,
                ensembler_params=None,
                architecture=arch,
            )
            payload = ckpt_lib.restore_payload(self._model_dir, ckpt_lib.frozen_filename(i))
            frozen.name = payload.get("name", frozen.name)
            ckpt_lib.payload_into_frozen(payload, frozen, self._device)
            prev = frozen
        return prev

    def _init_or_restore_state(self, iteration, sample_batch, info, training: bool = True):
        """The iteration's initial state, with the mid-iteration
        checkpoint of `info` loaded onto it when there is one. A corrupt
        state file is quarantined and the iteration restarts from its
        first step (the manifest rolled back to match); a state that
        does not fit the rebuilt iteration raises."""
        state = iteration.init_state(self._iteration_generator(iteration.iteration_number), sample_batch)
        if not info.iteration_state_file:
            return state
        try:
            payload = ckpt_lib.restore_payload(self._model_dir, info.iteration_state_file)
        except (ckpt_lib.CheckpointCorruptionError, OSError) as exc:
            _LOG.error(
                "Mid-iteration state corrupt at restore time (%s); rolling back to the start of iteration %d.",
                exc, info.iteration_number,
            )
            stale = info.iteration_state_file
            info.iteration_state_file = None
            info.global_step = integrity.end_step_of(info, self._model_dir, info.iteration_number)
            ckpt_lib.quarantine_file(self._model_dir, stale)
            ckpt_lib.write_manifest(self._model_dir, info)
            return state
        iteration_lib.restore_state(state, payload, restore_generator=training)
        _LOG.info("Restored mid-iteration state from %s", info.iteration_state_file)
        return state

    def _save_iteration_state(self, info, iteration_number, state) -> None:
        stale = info.iteration_state_file
        filename = ckpt_lib.iteration_state_filename(info.global_step)
        info.digests[filename] = ckpt_lib.save_payload(
            self._model_dir, filename, iteration_lib.state_payload(state)
        )
        info.iteration_number = iteration_number
        info.iteration_state_file = filename
        ckpt_lib.write_manifest(self._model_dir, info)
        # The manifest now points at the new state; the superseded file
        # would otherwise accumulate over a long search.
        self._remove_state_file(stale, keep=filename)

    def _remove_state_file(self, filename, keep=None) -> None:
        if not filename or filename == keep:
            return
        try:
            os.remove(os.path.join(self._model_dir, filename))
        except OSError:
            pass
        ckpt_lib.remove_digest(self._model_dir, filename)

    def _get_best_ensemble_index(self, iteration, state) -> int:
        """The reference's selection: the Evaluator's objective over its
        values when there is an Evaluator, else the EMA argmin; with
        `force_grow` at t>0 the carried-over ensemble is left out."""
        self._last_selection_values = None
        if len(iteration.ensemble_specs) == 1:
            return 0
        exclude_first = self._force_grow and iteration.iteration_number > 0
        if self._evaluator:
            values = self._evaluator.evaluate(iteration, state)
            self._last_selection_values = [float(v) for v in values]
            objective_fn = self._evaluator.objective_fn
            if exclude_first:
                return int(objective_fn(values[1:])) + 1
            return int(objective_fn(values))
        return iteration.best_candidate_index(state, exclude_first=exclude_first)

    def _complete_iteration(self, iteration, state, sample_batch, info) -> FrozenEnsemble:
        """Selects and freezes the winner; writes
        `candidate-metrics-<t>.json`, every candidate's final state with
        `keep_candidate_states`, `architecture-<t>.json`, the frozen
        payload, the subnetworks' reports with a `report_materializer`,
        and the manifest of iteration t+1 (history, replay indices, the
        generation bump), then drops the iteration's state file."""
        t = iteration.iteration_number
        best_index = self._get_best_ensemble_index(iteration, state)
        spec = iteration.ensemble_specs[best_index]
        _LOG.info("Iteration %d best ensemble: %s (index %d)", t, spec.name, best_index)
        frozen = iteration.freeze_candidate(state, spec.name, sample_batch)
        frozen.architecture.add_replay_index(best_index)
        frozen.architecture.set_global_step(info.global_step)
        self._write_candidate_metrics(iteration, state, best_index, info)
        if self._keep_candidate_states:
            final_name = ckpt_lib.final_state_filename(t)
            info.digests[final_name] = ckpt_lib.save_payload(
                self._model_dir, final_name, iteration_lib.state_payload(state)
            )
        ckpt_lib.write_text(self._model_dir, ckpt_lib.architecture_filename(t), frozen.architecture.serialize())
        frozen_name = ckpt_lib.frozen_filename(t)
        info.digests[frozen_name] = ckpt_lib.save_payload(
            self._model_dir, frozen_name, ckpt_lib.frozen_to_payload(frozen)
        )
        if self._report_materializer:
            included = [ws.subnetwork.name for ws in frozen.weighted_subnetworks if ws.subnetwork.iteration_number == t]
            reports = self._report_materializer.materialize_subnetwork_reports(iteration, state, included)
            self._report_accessor.write_iteration_report(t, reports)
        stale_state = info.iteration_state_file
        info.iteration_number = t + 1
        info.iteration_state_file = None
        info.replay_indices = frozen.architecture.replay_indices
        info.history.append(
            {"iteration_number": t, "global_step": int(info.global_step), "generation": info.generation + 1}
        )
        ckpt_lib.write_manifest(self._model_dir, info)
        self._remove_state_file(stale_state)
        if self._summary is not None:
            self._summary.close()
        return frozen

    def _write_candidate_metrics(self, iteration, state, best_index, info) -> None:
        """`candidate-metrics-<t>.json`: each candidate's last adanet
        loss, loss EMA, quarantine flag, its Evaluator value when an
        Evaluator chose, whether it won, and the global step; non-finite
        values as null. The numbers come back in one host read, and are
        also written as `ensemble/<name>/eval` summaries."""
        decay = iteration.adanet_loss_decay
        host = read_scalars({
            espec.name: {
                "adanet_loss": state.candidates[espec.name].adanet_loss,
                "adanet_loss_ema": candidate_lib.debiased_ema(state.candidates[espec.name], decay),
                "dead": state.candidates[espec.name].dead,
            }
            for espec in iteration.ensemble_specs
        })
        values = self._last_selection_values

        def finite(value):
            value = float(value)
            return value if math.isfinite(value) else None

        record = {}
        for i, espec in enumerate(iteration.ensemble_specs):
            entry = {
                "adanet_loss": finite(host[espec.name]["adanet_loss"]),
                "adanet_loss_ema": finite(host[espec.name]["adanet_loss_ema"]),
                "dead": bool(host[espec.name]["dead"]),
                "best": i == best_index,
                "global_step": int(info.global_step),
            }
            if values is not None and i < len(values):
                entry["evaluator_objective"] = finite(values[i])
            record[espec.name] = entry
        ckpt_lib.write_json(self._model_dir, ckpt_lib.candidate_metrics_filename(iteration.iteration_number), record)
        self._write_eval_summaries(
            {
                name: {
                    k: v for k, v in entry.items()
                    if k != "global_step" and isinstance(v, (int, float)) and not isinstance(v, bool)
                }
                for name, entry in record.items()
            },
            info.global_step,
        )

    def candidate_metrics(self, iteration_number: Optional[int] = None) -> Dict[str, Dict[str, Any]]:
        """Every candidate's selection metrics of a completed iteration
        (the last one by default), read from `candidate-metrics-<t>.json`;
        floats (None where non-finite), bools (`dead`, `best`) and the
        global step. For metrics on new data, `evaluate_all_candidates`."""
        if iteration_number is None:
            info = ckpt_lib.read_manifest(self._model_dir)
            if info is None or info.iteration_number == 0:
                raise ValueError("No completed iteration in %s." % self._model_dir)
            iteration_number = info.iteration_number - 1
        record = ckpt_lib.read_json(self._model_dir, ckpt_lib.candidate_metrics_filename(iteration_number))
        if record is None:
            raise ValueError(
                "No candidate metrics recorded for iteration %s in %s." % (iteration_number, self._model_dir)
            )
        return record

    def _write_eval_summaries(self, per_scope, global_step) -> None:
        """Per-candidate eval summaries under
        `<model_dir>/ensemble/<name>/eval`."""
        summary = ScopedSummary(self._model_dir)
        for name, metrics in per_scope.items():
            summary.scalars("ensemble", os.path.join(name, "eval"), metrics, global_step)
        summary.close()

    # ------------------------------------------------------ evaluate/predict

    def _on_device(self, device) -> "Estimator":
        """This estimator over the same `model_dir`, rebuilding on
        `device`."""
        twin = copy.copy(self)
        twin._device = device
        twin._iteration_builder = self._make_iteration_builder(device)
        return twin

    def _final_forward_fn(self, sample_batch):
        """(forward, name) of the best model: `forward(features)` returns
        its `Ensemble` (callers disable gradients and TF32). With a mid-iteration state the current best
        candidate serves; otherwise the winner of the last completed
        iteration, rebuilt from disk, so that a fresh Estimator serves
        what an earlier process trained."""
        info = ckpt_lib.read_manifest(self._model_dir)
        if info is None:
            raise ValueError("No checkpoint in %s; call train() first." % self._model_dir)
        if info.iteration_state_file:
            iteration = self._build_iteration(info.iteration_number, sample_batch)
            state = self._init_or_restore_state(iteration, sample_batch, info, training=False)
            name = iteration.ensemble_specs[self._get_best_ensemble_index(iteration, state)].name
            return (lambda features: iteration.candidate_forward(state, name, features)), name
        frozen = self._rebuild_previous_ensemble(info.iteration_number, sample_batch)
        if frozen is None:
            raise ValueError("No completed iteration to evaluate.")
        ensembler = self._iteration_builder._ensembler_by_name(frozen.ensembler_name)

        def forward(features):
            features = self._model_features(features)
            return ensembler.build_ensemble(frozen.ensembler_params, frozen.member_outputs(features))

        return forward, frozen.name

    def evaluate(self, input_fn: Callable[[], Iterator], steps: Optional[int] = None) -> Dict[str, Any]:
        """Evaluates the best model (`_final_forward_fn`) on up to `steps`
        batches of `input_fn`; returns the head's metrics and `loss`,
        averaged by example count (total example weight under a
        `weight_key`), the `metric_fn`'s (its two-argument form by example
        count), with `best_ensemble` and `global_step`."""
        data = iter(input_fn())
        try:
            first = next(data)
        except StopIteration:
            raise ValueError("input_fn yielded no batches.")
        forward, name = self._final_forward_fn(first)
        # A metric_fn taking (logits, labels, weights) opts into example
        # weighting; the two-argument form is a plain mean a batch.
        metric_fn_weighted = False
        if self._metric_fn is not None and self._weight_key is not None:
            try:
                metric_fn_weighted = len(inspect.signature(self._metric_fn).parameters) >= 3
            except (TypeError, ValueError):
                metric_fn_weighted = False
        acc = WeightedMeanAccumulator()
        custom_acc = WeightedMeanAccumulator()
        staged = []

        def drain():
            # One host read for a window of batches' metrics.
            host = read_scalars({
                "%d/%s" % (i, part): values for i, (metrics, custom, _, _) in enumerate(staged)
                for part, values in (("head", metrics), ("custom", custom))
            })
            for i, (_, custom, n, n_examples) in enumerate(staged):
                acc.add(host["%d/head" % i], n)
                if custom:
                    custom_acc.add(host["%d/custom" % i], n_examples)
            staged.clear()

        with full_f32_matmul(), torch.no_grad():
            for index, batch in enumerate(itertools.chain([first], data)):
                if steps is not None and index >= steps:
                    break
                if self._debug:
                    _check_batch_finite(batch)
                n = batch_metric_weight(batch, self._weight_key)
                n_examples = batch_example_count(batch)
                features, labels = to_device(batch, self._device)
                features, weights = split_example_weights(features, self._weight_key)
                logits = forward(features).logits
                metrics = dict(self._head.eval_metrics(logits, labels, weights))
                metrics["loss"] = self._head.loss(logits, labels, weights)
                custom = {}
                if self._metric_fn is not None:
                    if metric_fn_weighted:
                        metrics.update(self._metric_fn(logits, labels, weights))
                    else:
                        custom = dict(self._metric_fn(logits, labels))
                staged.append((metrics, custom, n, n_examples))
                if len(staged) >= EVAL_FETCH_WINDOW:
                    drain()
            if staged:
                drain()
        result = acc.means()
        if custom_acc.batches:
            result.update(custom_acc.means())
        self._write_eval_summaries({name: result}, self.latest_global_step())
        result["best_ensemble"] = name
        result["global_step"] = self.latest_global_step()
        return result

    def evaluate_all_candidates(
        self,
        input_fn: Callable[[], Iterator],
        steps: Optional[int] = None,
        iteration_number: Optional[int] = None,
    ) -> Dict[str, Dict[str, float]]:
        """Every candidate's metrics over a dataset, in one pass (one
        `Iteration.eval_step` and one host read a batch), also written to
        `<model_dir>/ensemble/<name>/eval`. Uses the live mid-iteration
        state when there is one (and `iteration_number` is None);
        completed iterations use the states retained under
        `keep_candidate_states=True` (`iteration_number` selects one; the
        latest by default)."""
        info = ckpt_lib.read_manifest(self._model_dir)
        if info is None:
            raise ValueError("No checkpoint in %s; call train() first." % self._model_dir)
        data = iter(input_fn())
        try:
            first = next(data)
        except StopIteration:
            raise ValueError("input_fn yielded no batches.")
        if info.iteration_state_file and iteration_number is None:
            iteration = self._build_iteration(info.iteration_number, first)
            state = self._init_or_restore_state(iteration, first, info, training=False)
        else:
            t = info.iteration_number - 1 if iteration_number is None else int(iteration_number)
            retained = ckpt_lib.final_state_filename(t)
            if t < 0 or not os.path.exists(os.path.join(self._model_dir, retained)):
                raise ValueError(
                    "evaluate_all_candidates needs retained candidate states for iteration %d; construct the "
                    "Estimator with keep_candidate_states=True (or call during an iteration, from a mid-iteration "
                    "checkpoint). The selection metrics recorded at iteration end are always available via "
                    "candidate_metrics(%d)." % (t, t)
                )
            iteration = self._build_iteration(t, first)
            state = iteration.init_state(self._iteration_generator(t), first)
            iteration_lib.restore_state(
                state, ckpt_lib.restore_payload(self._model_dir, retained), restore_generator=False
            )
        names = iteration.candidate_names()
        accs = {n: WeightedMeanAccumulator() for n in names}
        for index, batch in enumerate(itertools.chain([first], data)):
            if steps is not None and index >= steps:
                break
            if self._debug:
                _check_batch_finite(batch)
            size = batch_metric_weight(batch, self._weight_key)
            results = iteration.eval_step(state, batch)
            host = read_scalars({n: results[n] for n in names})
            for n in names:
                accs[n].add(host[n], size)
        results = {n: accs[n].means() for n in names}
        self._write_eval_summaries(results, info.global_step)
        return results

    def predict(self, input_fn: Callable[[], Iterator], on_cpu: bool = False):
        """Yields the head's predictions of the best model
        (`_final_forward_fn`) for each batch of `input_fn` (features, or
        (features, labels)), as CPU tensors. `on_cpu=True` rebuilds the
        model on the CPU and predicts there, when the caller wants it
        (a model too large for the card's memory; the reference's
        inference fallback for embedding tables on the host); nothing
        moves to the CPU otherwise."""
        data = iter(input_fn())
        try:
            first = next(data)
        except StopIteration:
            return
        owner = self._on_device(torch.device("cpu")) if on_cpu else self
        features0 = first[0] if isinstance(first, tuple) else first
        forward, _ = owner._final_forward_fn((features0, None))
        for batch in itertools.chain([first], data):
            features = to_device(batch[0] if isinstance(batch, tuple) else batch, owner._device)
            # Prediction features may carry the weight column; it never
            # feeds the model.
            features = self._model_features(features)
            with full_f32_matmul(), torch.no_grad():
                predictions = self._head.predictions(forward(features).logits)
            yield {key: value.cpu() for key, value in predictions.items()}
