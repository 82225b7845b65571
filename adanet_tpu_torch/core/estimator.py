"""The AdaNet Estimator: the user-facing search loop.

Port of adanet_tpu/core/estimator.py, single process:

    fsck the model dir, read the manifest     integrity.fsck
    while not done:
        generate candidates (user code)      _generate_builders
        rebuild the previous winner from
        disk on a fresh start                _rebuild_previous_ensemble
        init, or restore the mid-iteration
        state                                _init_or_restore_state
        train all candidates, step by step   Iteration.train_step
        checkpoint every save_checkpoint_steps, and on a stop inside the
        iteration (max_steps, SIGTERM)       _save_iteration_state
        select the best (EMA, force_grow)    _get_best_ensemble_index
        write architecture-<t>.json, the
        frozen payload and the manifest      _complete_iteration

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

`model_dir` holds the JAX package's checkpoint layout
(`core/checkpoint.py`): `architecture-<t>.json` (the JAX package's file,
byte for byte), `frozen-<t>.pt`, `ckpt-<step>.pt` and the manifest
`checkpoint.json`, every payload written atomically beside its digest.
A search stopped anywhere (`max_steps`, SIGTERM, a crash) resumes from
`model_dir` in a fresh process. The generator's reports
(`report_materializer`), the candidate-metrics file, the artifact store,
serving export, multi-host placement, input prefetch and profiling come
with later slices.
"""

from __future__ import annotations

import itertools
import logging
import os
import signal
import tempfile
import threading
from typing import Any, Callable, Dict, Iterator, Optional, Sequence

import numpy as np
import torch

from adanet_tpu_torch._device import resolve_device
from adanet_tpu_torch.core import checkpoint as ckpt_lib
from adanet_tpu_torch.core import iteration as iteration_lib
from adanet_tpu_torch.core.architecture import Architecture
from adanet_tpu_torch.core.frozen import FrozenEnsemble, FrozenWeightedSubnetwork, rebuild_subnetwork
from adanet_tpu_torch.core.iteration import Iteration, IterationBuilder
from adanet_tpu_torch.core.summary import ScopedSummary
from adanet_tpu_torch.ensemble.strategy import GrowStrategy
from adanet_tpu_torch.ensemble.weighted import ComplexityRegularizedEnsembler, full_f32_matmul
from adanet_tpu_torch.robustness import faults as faults_lib
from adanet_tpu_torch.robustness import integrity
from adanet_tpu_torch.robustness import retry as retry_lib
from adanet_tpu_torch.utils.batches import (
    EVAL_FETCH_WINDOW,
    WeightedMeanAccumulator,
    batch_example_count,
    feature_shape,
    to_device,
)

_LOG = logging.getLogger("adanet_tpu_torch")


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
      adanet_loss_decay: EMA decay of candidate tracking.
      force_grow: at t>0 never re-select the carried-over previous ensemble.
      max_iterations: stop after this many iterations (None = until
        max_steps).
      model_dir: where the checkpoints are written and read; a temp dir
        when None.
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
        save_checkpoint_steps: Optional[int] = None,
        log_every_steps: int = 100,
        checkpoint_on_sigterm: bool = True,
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
        self._save_checkpoint_steps = save_checkpoint_steps
        self._log_every_steps = int(log_every_steps)
        self._checkpoint_on_sigterm = bool(checkpoint_on_sigterm)
        self._stop_requested = False
        self._summary: Optional[ScopedSummary] = None
        self._iteration_builder = IterationBuilder(
            head=head,
            ensemblers=self._ensemblers,
            ensemble_strategies=self._strategies,
            adanet_loss_decay=self._adanet_loss_decay,
            collect_summaries=self._log_every_steps > 0,
            device=self._device,
        )
        # The winner of the last iteration this train() call completed;
        # the first iteration of a call rebuilds its previous from disk.
        self._previous: Optional[FrozenEnsemble] = None

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
            while (
                steps_done < self._max_iteration_steps
                and not self._stop_requested
                and (max_steps is None or info.global_step < max_steps)
            ):
                batch, data_iter = self._next_batch(input_fn, data_iter)
                state, metrics = iteration.train_step(state, batch)
                steps_done += 1
                info.global_step += 1
                if self._log_every_steps and steps_done % self._log_every_steps == 0:
                    emas = iteration.ema_losses(state)
                    _LOG.info(
                        "iteration %d step %d/%d adanet_loss EMAs: %s",
                        t, steps_done, self._max_iteration_steps,
                        {k: round(v, 6) for k, v in emas.items()},
                    )
                    self._write_train_summaries(iteration, metrics, emas, state, info.global_step)
                if self._save_checkpoint_steps and steps_done % self._save_checkpoint_steps == 0:
                    self._save_iteration_state(info, t, state)
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
        if previous is None or previous.iteration_number != iteration_number - 1:
            previous = self._rebuild_previous_ensemble(iteration_number, sample_batch)
        builders = self._generate_builders(iteration_number, previous)
        return self._iteration_builder.build_iteration(
            iteration_number, builders, previous, input_shape=feature_shape(sample_batch[0])
        )

    def _rebuild_previous_ensemble(self, iteration_number: int, sample_batch) -> Optional[FrozenEnsemble]:
        """Rebuilds the frozen winner of t-1 from disk: replays the
        generator for each past iteration, rebuilds the winner's new
        members' modules and loads the frozen payload's numbers onto
        them (reference: estimator.py:1785-1882)."""
        prev: Optional[FrozenEnsemble] = None
        input_shape = feature_shape(sample_batch[0])
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
        """The EMA selection, with `force_grow` at t>0."""
        if len(iteration.ensemble_specs) == 1:
            return 0
        exclude_first = self._force_grow and iteration.iteration_number > 0
        return iteration.best_candidate_index(state, exclude_first=exclude_first)

    def _complete_iteration(self, iteration, state, sample_batch, info) -> FrozenEnsemble:
        """Selects and freezes the winner; writes `architecture-<t>.json`,
        the frozen payload and the manifest of iteration t+1 (history,
        replay indices, the generation bump), then drops the iteration's
        state file."""
        t = iteration.iteration_number
        best_index = self._get_best_ensemble_index(iteration, state)
        spec = iteration.ensemble_specs[best_index]
        _LOG.info("Iteration %d best ensemble: %s (index %d)", t, spec.name, best_index)
        frozen = iteration.freeze_candidate(state, spec.name, sample_batch)
        frozen.architecture.add_replay_index(best_index)
        frozen.architecture.set_global_step(info.global_step)
        ckpt_lib.write_text(self._model_dir, ckpt_lib.architecture_filename(t), frozen.architecture.serialize())
        frozen_name = ckpt_lib.frozen_filename(t)
        info.digests[frozen_name] = ckpt_lib.save_payload(
            self._model_dir, frozen_name, ckpt_lib.frozen_to_payload(frozen)
        )
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

    # ------------------------------------------------------ evaluate/predict

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
            return ensembler.build_ensemble(frozen.ensembler_params, frozen.member_outputs(features))

        return forward, frozen.name

    def evaluate(self, input_fn: Callable[[], Iterator], steps: Optional[int] = None) -> Dict[str, Any]:
        """Evaluates the best model (`_final_forward_fn`) on up to `steps`
        batches of `input_fn`; returns the head's metrics and `loss`
        averaged by example count, with `best_ensemble` and
        `global_step`."""
        data = iter(input_fn())
        try:
            first = next(data)
        except StopIteration:
            raise ValueError("input_fn yielded no batches.")
        forward, name = self._final_forward_fn(first)
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
            for index, batch in enumerate(itertools.chain([first], data)):
                if steps is not None and index >= steps:
                    break
                n = batch_example_count(batch)
                features, labels = to_device(batch, self._device)
                logits = forward(features).logits
                metrics = dict(self._head.eval_metrics(logits, labels))
                metrics["loss"] = self._head.loss(logits, labels)
                staged.append((metrics, n))
                if len(staged) >= EVAL_FETCH_WINDOW:
                    drain()
            if staged:
                drain()
        result = acc.means()
        result["best_ensemble"] = name
        result["global_step"] = self.latest_global_step()
        return result

    def predict(self, input_fn: Callable[[], Iterator]):
        """Yields the head's predictions of the best model
        (`_final_forward_fn`) for each batch of `input_fn` (features, or
        (features, labels)), as CPU tensors."""
        data = iter(input_fn())
        try:
            first = next(data)
        except StopIteration:
            return
        features0 = first[0] if isinstance(first, tuple) else first
        forward, _ = self._final_forward_fn((features0, None))
        for batch in itertools.chain([first], data):
            features = to_device(batch[0] if isinstance(batch, tuple) else batch, self._device)
            with full_f32_matmul(), torch.no_grad():
                predictions = self._head.predictions(forward(features).logits)
            yield {key: value.cpu() for key, value in predictions.items()}
