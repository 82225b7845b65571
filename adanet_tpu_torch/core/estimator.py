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
weight column, which every loss and metric is weighted by.

Replay and bagging: a `replay_config` (`replay.Config`) takes each
recorded iteration's winner without running the Evaluator, and
`replay.json` is written after every completed iteration and at search
end; a builder with a `train_input_fn` (an AutoEnsemble candidate's
bagging stream) trains on batches from its own iterator, opened each
iteration through the same debug check and prefetch as the shared one
and closed when the iteration ends, and such an iteration takes single
steps whatever `iterations_per_loop` says.

Export and serving (`core/export.py`, `serving/`): `export_saved_model`
writes the winner's durable payload (`architecture.json`,
`ensemble.pt`) and a hermetic `torch.export` program of its whole
prediction function (`serving.pt2`), which a fresh process serves with
no builder code; `export_subnetwork_logits` and
`export_subnetwork_last_layer` add every member's outputs to `predict`
and to that program. `export_serving` publishes each completed
iteration as a generation under `<model_dir>/serving/gen-<t>/` (the
chief, after the manifest; a failure is logged, never raised), by
default with a calibrated cascade (`serving_cascade`): the cheapest
member's program and its confidence threshold, calibrated on a
reservoir of training feature batches.

The artifact store (`store/`, `artifact_store`): the chief holds a TTL
lease on the store while it trains and publishes every completed
iteration's architecture and frozen payload under a ref keyed by the
winner's architecture hash, the iteration and the search's spec
fingerprint (seed, step budget, `store_spec_extra` and the port's
payload format, so that a JAX search's msgpack payloads and the port's
never share a ref); with `export_serving`, each generation's files too.
A store failure is logged, never raised. A search given a
`replay_config` whose recorded winner of iteration t is in the store
grafts it instead of training: no batch, no training step, no kernel
launch, the same manifest advance and `replay.json`.

Placement and processes (`distributed/`): a `RoundRobinStrategy` trains
each iteration through `distributed.executor.RoundRobinExecutor` (each
subnetwork in its group, the mixture weights in the ensemble group on
member copies synced every step). Several processes
(`distributed.coordination.initialize`) train one search data-parallel
by default: each feeds its local slice of every global batch from its
own `input_fn`, losses and gradients are all-reduced
(`Iteration.set_process_group`), so every process ends with the same
parameters; the Evaluator and the reports run collectively, and the
stop checks (SIGTERM, once every `_stop_check_interval` steps) agree
through the process group's store, so that a signal to one process
stops every process at the same step. Only the chief (process 0) writes
anything (checkpoints, frozen payloads, reports, metrics files, the
replay record) and keeps a heartbeat file; a worker waits on the
manifest for the chief's bookkeeping (`worker_wait_timeout_secs`).

A `RoundRobinStrategy` across processes trains through
`distributed.multihost.MultiHostRoundRobinExecutor`: each process trains
the candidate groups it owns on its own batches, members sync through
the process group's store, and the chief alone keeps the books. A peer
that stops answering is declared lost (`_peer_lost`): its candidates are
quarantined, the iteration finishes with the survivors, the agreements
become process-local, and the search stops at that iteration's end,
resumable from the checkpoint (the flight recorder dumps `peer_lost`).

An `ElasticWorkQueueStrategy` trains each iteration by draining a
lease-based work queue (`distributed.scheduler.ElasticWorkQueueExecutor`,
`_drain_elastic_iteration`), in one process or several. Every process
feeds the identical full stream, read by absolute step through
`_BatchLog`, so that a unit re-issued after a worker's death replays its
batches; a dead worker costs one lease TTL. Speculation
(`speculate_steps`) pre-trains the next iteration's candidates against
the likely winner on the chief and grafts the windows in when the winner
holds (never beside a `report_materializer`; a failure of speculation is
logged, never raised).

Under several processes every process agrees on a mid-iteration
restore (`_init_or_restore_state`): if any process's read of the state
file fails, all roll back to the iteration's start, and only the chief
quarantines the file and writes the manifest.
"""

from __future__ import annotations

import copy
import inspect
import itertools
import json
import logging
import math
import os
import signal
import tempfile
import threading
from typing import Any, Callable, Dict, Iterator, Optional, Sequence

import numpy as np
import torch

from adanet_tpu_torch import replay as replay_lib
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
from adanet_tpu_torch.distributed import coordination
from adanet_tpu_torch.distributed.executor import RoundRobinExecutor
from adanet_tpu_torch.distributed.placement import ElasticWorkQueueStrategy, ReplicationStrategy, RoundRobinStrategy
from adanet_tpu_torch.ensemble.strategy import GrowStrategy
from adanet_tpu_torch.ensemble.weighted import ComplexityRegularizedEnsembler, full_f32_matmul
from adanet_tpu_torch.observability import flightrec as flightrec_lib
from adanet_tpu_torch.observability import metrics as metrics_lib
from adanet_tpu_torch.observability import spans as spans_lib
from adanet_tpu_torch.robustness import faults as faults_lib
from adanet_tpu_torch.robustness import integrity
from adanet_tpu_torch.robustness import retry as retry_lib
from adanet_tpu_torch.robustness import watchdog as watchdog_lib
from adanet_tpu_torch.utils import precision
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


def _leaves_with_path(tree, path=""):
    """(path, leaf) of `tree` but None, the path as the JAX package's
    `keystr` writes it (`[0]['x']`), dict entries in sorted key order."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves_with_path(tree[key], "%s[%r]" % (path, key))
    elif isinstance(tree, (list, tuple)):
        for i, item in enumerate(tree):
            yield from _leaves_with_path(item, "%s[%d]" % (path, i))
    elif tree is not None:
        yield path, tree


def _check_batch_finite(batch) -> None:
    """Raises `FloatingPointError`, naming the leaf, when a float leaf of
    the batch is not finite (`debug=True`)."""
    for path, leaf in _leaves_with_path(batch):
        if torch.is_tensor(leaf):
            leaf = leaf.detach().float().cpu().numpy() if leaf.is_floating_point() else None
        if leaf is None or not np.issubdtype(np.asarray(leaf).dtype, np.floating):
            continue
        if not np.all(np.isfinite(leaf)):
            raise FloatingPointError("Non-finite values in input batch at %s (debug=True)." % path)


class _Prepended:
    """`first`, then the rest of the iterator `source` (which a close
    reaches through `source`)."""

    def __init__(self, first, source):
        self._first, self.source = [first], source

    def __iter__(self):
        return self

    def __next__(self):
        return self._first.pop() if self._first else next(self.source)


def _host_tree(tree):
    """`tree` with every tensor or array leaf copied to a host numpy array."""
    if isinstance(tree, dict):
        return {key: _host_tree(value) for key, value in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host_tree(value) for value in tree)
    if torch.is_tensor(tree):
        return tree.detach().cpu().numpy()
    return np.array(tree, copy=True)


def _cpu_tree(tree):
    if isinstance(tree, dict):
        return {key: _cpu_tree(value) for key, value in tree.items()}
    return tree.cpu()


def _checked(source):
    for batch in source:
        _check_batch_finite(batch)
        yield batch


class _BatchLog:
    """Deterministic absolute-index access to a training stream.

    The elastic scheduler's data contract: the batch for global step g
    is a pure function of g, so a work unit re-issued to a survivor (or
    re-executed after a restart) replays the exact batches its first
    execution consumed. Backed by the usual `input_fn` iterator —
    re-invoked on exhaustion, exactly like `Estimator._next_batch` — with
    a cache of the indices the current iteration may still re-issue
    (`forget_below` trims it at iteration boundaries).
    """

    def __init__(self, make_iter, check=None, close_iter=None):
        self._make_iter = make_iter
        self._check = check
        self._close_iter = close_iter
        self._iter = None
        self._next_index = 0
        self._cache: Dict[int, Any] = {}

    def _reset(self):
        """Releases the live iterator — a long search crosses many epoch
        boundaries and must not retain a dead prefetcher (and its parked
        worker thread) per boundary."""
        if self._iter is not None and self._close_iter is not None:
            self._close_iter(self._iter)
        self._iter = None

    def _swap_iter(self):
        self._reset()
        self._iter = self._make_iter()

    def batch_at(self, index: int):
        if index in self._cache:
            return self._cache[index]
        if index < self._next_index:
            # An evicted prefix: restart the stream and replay —
            # input_fn streams are deterministic from the top, the same
            # property checkpoint resume already relies on.
            self._reset()
            self._next_index = 0
        while self._next_index <= index:
            self._cache[self._next_index] = self._pull()
            self._next_index += 1
        return self._cache[index]

    def _next_wrapping(self):
        """One raw pull, re-opening the stream at epoch end."""
        try:
            return next(self._iter)
        except StopIteration:
            self._swap_iter()
            try:
                return next(self._iter)
            except StopIteration:
                raise ValueError("input_fn yielded no batches.")

    def _pull(self):
        """The batch at stream position `self._next_index`.

        A transient failure closes the pipeline; the next attempt
        re-opens it and deterministically replays to the current
        position (wrap-aware: a position past one epoch re-walks the
        epochs exactly as the original pulls did). The replay runs
        INSIDE the bounded retry, so a second hiccup mid-replay consumes
        the next attempt instead of escaping the loop.
        """
        position = self._next_index
        for attempt in range(3):
            try:
                faults_lib.trip("data.pull")
                if self._iter is None:
                    self._swap_iter()
                    for _ in range(position):
                        self._next_wrapping()
                batch = self._next_wrapping()
                if self._check is not None:
                    self._check(batch)
                return batch
            except Exception as exc:
                if attempt == 2 or not retry_lib.is_transient(exc):
                    raise
                _LOG.warning(
                    "Transient data-source failure in the elastic batch log (attempt %d/3): %s; re-opening the "
                    "pipeline.", attempt + 1, exc,
                )
                self._reset()
        raise AssertionError("unreachable")  # pragma: no cover

    def forget_below(self, index: int) -> None:
        for key in [k for k in self._cache if k < index]:
            del self._cache[key]


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
      replay_config: a `replay.Config`: each iteration it records takes
        the recorded winner, and no Evaluator runs for it.
      placement_strategy: None or a `ReplicationStrategy` (the fused
        step; data-parallel across processes), a `RoundRobinStrategy`
        (`RoundRobinExecutor` in one process,
        `MultiHostRoundRobinExecutor` across processes), or an
        `ElasticWorkQueueStrategy` (the work queue's drain).
      worker_wait_timeout_secs: how long a worker waits for the chief to
        complete an iteration before `WorkerWaitTimeout`.
      enable_summaries: write the train and eval summaries (with
        `log_every_steps` > 0 for the train ones).
      export_subnetwork_logits, export_subnetwork_last_layer: add each
        member's logits (`subnetwork_logits/<i>`) and last layer
        (`subnetwork_last_layer/<i>`) to the predictions of `predict` and
        of the exported program.
      export_serving: publish every completed iteration's winner as a
        serving generation.
      serving_cascade: publish each generation with a cascade of its
        cheapest member, calibrated to `cascade_target_agreement` with the
        full ensemble on the last `cascade_calibration_batches` sampled
        training feature batches.
      artifact_store: an `adanet_tpu_torch.store.ArtifactStore` or its
        root path, shared by searches and serving pools: completed
        iterations are published to it and, with a `replay_config`,
        grafted from it.
      store_spec_extra: extra configuration (JSON-able) folded into the
        store spec fingerprint (`store.keys.search_spec_fingerprint`):
        whatever makes the same architecture train to different numbers.
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
        replay_config=None,
        placement_strategy=None,
        worker_wait_timeout_secs: float = 7200.0,
        enable_summaries: bool = True,
        export_subnetwork_logits: bool = False,
        export_subnetwork_last_layer: bool = False,
        export_serving: bool = False,
        serving_cascade: bool = True,
        cascade_target_agreement: float = 0.995,
        cascade_calibration_batches: int = 8,
        artifact_store=None,
        store_spec_extra: Optional[Dict[str, Any]] = None,
    ):
        if cascade_calibration_batches < 1:
            raise ValueError("cascade_calibration_batches must be >= 1.")
        if placement_strategy is not None and not isinstance(
            placement_strategy, (ReplicationStrategy, RoundRobinStrategy, ElasticWorkQueueStrategy)
        ):
            raise ValueError(
                "Unsupported placement strategy %r: use ReplicationStrategy, RoundRobinStrategy or "
                "ElasticWorkQueueStrategy." % (placement_strategy,)
            )
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
        self._replay_config = replay_config
        self._placement_strategy = placement_strategy
        self._worker_wait_timeout_secs = float(worker_wait_timeout_secs)
        # The data-parallel process group while train() runs across
        # processes (None otherwise).
        self._process_group = None
        # Whether the stop checks agree across processes (every placement
        # across processes but the elastic queue, whose units re-issue).
        self._collective = False
        # The elastic drive's per-train() batch log and speculation stash,
        # and a count of drains (each drain's queue namespace).
        self._elastic_batches: Optional[_BatchLog] = None
        self._speculation: Optional[dict] = None
        self._elastic_epoch = 0
        self._last_stop_check_step = 0
        self._peer_lost: Optional[watchdog_lib.PeerLostError] = None
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
        self._enable_summaries = bool(enable_summaries)
        self._export_subnetwork_logits = bool(export_subnetwork_logits)
        self._export_subnetwork_last_layer = bool(export_subnetwork_last_layer)
        # Serve while searching: the chief publishes every completed
        # iteration's winner as a generation, by default with a cascade
        # calibrated on a reservoir of host copies of sampled training
        # feature batches (`_stash_calibration_batch`).
        self._export_serving = bool(export_serving)
        self._serving_cascade = bool(serving_cascade)
        self._cascade_target_agreement = float(cascade_target_agreement)
        self._cascade_calibration_batches = int(cascade_calibration_batches)
        self._cascade_calibration: list = []
        self._calibration_pulls = 0
        # The shared artifact store, its spec fingerprint's extra
        # ingredients (checked now, not at the first publication hours
        # later), the chief's lease while it trains, and the iterations
        # this Estimator grafted from the store (the registry counter
        # `estimator.replay.store_grafts` carries the process total).
        self._store_spec_extra = dict(store_spec_extra) if store_spec_extra else None
        if store_spec_extra is not None:
            self._store_spec_fingerprint()
        self._artifact_store = None
        if artifact_store is not None:
            from adanet_tpu_torch.store import ArtifactStore

            self._artifact_store = (
                artifact_store if isinstance(artifact_store, ArtifactStore) else ArtifactStore(str(artifact_store))
            )
        self._store_lease = None
        self._warned_replay_serving = False
        self._store_graft_count = 0
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
            collect_summaries=self._enable_summaries and self._log_every_steps > 0,
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
        world = coordination.process_count()
        # Verify and heal before trusting any bytes: corrupt files are
        # quarantined and the manifest rolls back to the newest intact
        # generation (every process computes the same healed state; the
        # chief alone repairs).
        heal = integrity.fsck(self._model_dir, repair=coordination.is_chief())
        if heal.rolled_back_to_iteration is not None:
            log = _LOG.error if heal.verdict == "unrecoverable" else _LOG.warning
            log(
                "Checkpoint %s: rolled back to iteration %d (global step %s); quarantined %s.",
                heal.verdict, heal.rolled_back_to_iteration, heal.rolled_back_global_step,
                heal.quarantined or heal.issues,
            )
        info = heal.info or ckpt_lib.CheckpointInfo()
        if self._artifact_store is not None and coordination.is_chief():
            # Pin what this search references against a concurrent GC
            # (a killed search's pins expire after one TTL), and publish
            # again each completed iteration whose ref is missing (a crash
            # between the artifact and the ref writes).
            from adanet_tpu_torch.store import leases as store_leases

            self._store_lease = store_leases.acquire(
                self._artifact_store, owner="search-%d" % os.getpid(), ttl_secs=self._store_lease_ttl_secs()
            )
            self._store_reconcile(info)
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
        self._peer_lost = None
        elastic = isinstance(self._placement_strategy, ElasticWorkQueueStrategy)
        # Data-parallel across processes only under the default placement:
        # RoundRobin groups and elastic units train on their own.
        data_parallel = world > 1 and not isinstance(
            self._placement_strategy, (RoundRobinStrategy, ElasticWorkQueueStrategy)
        )
        self._process_group = torch.distributed.group.WORLD if data_parallel else None
        self._collective = world > 1 and not elastic
        self._elastic_batches = None
        self._speculation = None
        heartbeat = None
        if world > 1 and coordination.is_chief():
            heartbeat = watchdog_lib.HeartbeatWriter(self._model_dir, role="chief").start()
        # The telemetry plane: a flight recorder rooted at the model dir
        # (shared with a serving pool over the same dir; a search over a
        # new dir rebinds, so that its dumps land under its model dir) and
        # a search span whose correlation ID every nested span (window,
        # iteration, checkpoint) inherits.
        flightrec_lib.install_default(os.path.join(self._model_dir, flightrec_lib.DEFAULT_SUBDIR))
        self._search_id = "%s-p%d" % (os.path.basename(os.path.normpath(self._model_dir)) or "search", os.getpid())
        try:
            with spans_lib.tracer().span("search", correlation={"search_id": self._search_id}, max_steps=max_steps):
                with full_f32_matmul():
                    self._train_loop(input_fn, max_steps, info)
            if self._stop_requested:
                # The SIGTERM checkpoint-and-stop path leaves its trace
                # (the dump runs outside the signal handler).
                flightrec_lib.dump_installed("sigterm_stop")
            if self._peer_lost is not None:
                flightrec_lib.dump_installed("peer_lost", extra={"error": str(self._peer_lost)})
            if coordination.is_chief():
                # Search end: once more, for a resumed run that completed
                # no iteration in this call.
                self._write_replay_record()
        finally:
            if self._store_lease is not None:
                from adanet_tpu_torch.store import leases as store_leases

                store_leases.release(self._artifact_store, self._store_lease)
                self._store_lease = None
            # evaluate() and predict() after train() are local to each
            # process: a process group left set would turn them into
            # collectives that hang unless every process joins.
            self._process_group = None
            if heartbeat is not None:
                heartbeat.stop()
            if handler_installed:
                signal.signal(signal.SIGTERM, previous_handler if previous_handler is not None else signal.SIG_DFL)
            # A worker abandoned mid-stream would park on its queue, with
            # its batches, until the process exits.
            if self._elastic_batches is not None:
                self._elastic_batches._reset()
                self._elastic_batches = None
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
            if self._should_stop():
                break
            if self._max_iterations is not None and t >= self._max_iterations:
                _LOG.info("Reached max_iterations=%d.", self._max_iterations)
                break
            if max_steps is not None and info.global_step >= max_steps:
                break
            if self._try_store_replay(t, info):
                # The recorded winner of iteration t was grafted from the
                # store: no batch, no step; the next trained iteration
                # rebuilds its previous ensemble from disk.
                self._previous = None
                continue

            batch, data_iter = self._next_batch(input_fn, data_iter)
            sample_batch = batch
            if isinstance(data_iter, _Prepended):  # spent by the pull above
                data_iter = data_iter.source
            data_iter = _Prepended(batch, data_iter)
            iteration = self._build_iteration(t, sample_batch)
            state = self._init_or_restore_state(iteration, sample_batch, info)
            executor = None
            elastic = isinstance(self._placement_strategy, ElasticWorkQueueStrategy)
            if elastic:
                from adanet_tpu_torch.distributed.scheduler import ElasticWorkQueueExecutor

                executor = ElasticWorkQueueExecutor(iteration, self._placement_strategy)
            elif isinstance(self._placement_strategy, RoundRobinStrategy):
                if coordination.process_count() > 1:
                    from adanet_tpu_torch.distributed.multihost import MultiHostRoundRobinExecutor

                    executor = MultiHostRoundRobinExecutor(iteration, self._placement_strategy)
                else:
                    executor = RoundRobinExecutor(iteration, self._placement_strategy)
            if executor is not None:
                state = executor.place(state)
            multihost = executor is not None and executor.is_multihost
            train_step = executor.train_step if executor is not None else iteration.train_step
            train_steps = executor.train_steps if executor is not None else iteration.train_steps
            steps_done = state.iteration_step
            self._last_stop_check_step = steps_done
            _LOG.info(
                "Starting iteration %d at iteration_step %d (global step %d): candidates=%s",
                t, steps_done, info.global_step, iteration.candidate_names(),
            )
            profile = None
            profile_stop_at = None
            dead: set = set()
            # Candidates with their own training data (bagging) pull from
            # their own streams, opened afresh each iteration.
            extra_input_fns = {
                spec.name: spec.builder.train_input_fn
                for spec in iteration.subnetwork_specs
                if getattr(spec.builder, "train_input_fn", None) is not None
            }
            extra_iters: Dict[str, Iterator] = {}
            if elastic:
                # The queue's drain replaces the lockstep round.
                with spans_lib.tracer().span("iteration.drain", correlation={"iteration": t}):
                    state, steps_done = self._drain_elastic_iteration(
                        executor, iteration, state, info, t, steps_done, max_steps, input_fn
                    )
            while (
                not elastic
                and steps_done < self._max_iteration_steps
                and not self._should_stop_at(steps_done)
                and (max_steps is None or info.global_step < max_steps)
            ):
                if self._profile_dir and profile_stop_at is None:
                    profile = self._start_profile()
                    profile_stop_at = steps_done + self._profile_steps
                budget = self._max_iteration_steps - steps_done
                if max_steps is not None:
                    budget = min(budget, max_steps - info.global_step)
                if extra_input_fns:
                    # Bagged candidates pull their own batch each step, so
                    # an iteration with one takes single steps.
                    loop_size = 1
                    batch, data_iter = self._next_batch(input_fn, data_iter)
                    extra_batches = {}
                    for name, fn in extra_input_fns.items():
                        extra_batches[name], extra_iters[name] = self._next_batch(fn, extra_iters.get(name))
                    # A dispatch span: host-side enqueue; the device finishes
                    # asynchronously, and the span reads nothing from it.
                    with spans_lib.tracer().span("train_window", correlation={"iteration": t}, steps=1):
                        state, metrics = train_step(state, batch, extra_batches)
                else:
                    loop_size = min(self._iterations_per_loop, budget)
                    batches = []
                    for _ in range(loop_size):
                        batch, data_iter = self._next_batch(input_fn, data_iter)
                        batches.append(batch)
                    with spans_lib.tracer().span("train_window", correlation={"iteration": t}, steps=loop_size):
                        state, metrics = train_steps(state, batches)
                prev_steps_done = steps_done
                steps_done += loop_size
                info.global_step += loop_size
                if multihost and self._peer_lost is None and executor.lost_peers:
                    # A peer was declared dead mid-iteration: finish the
                    # iteration with the survivors, then stop at its end.
                    self._peer_lost = executor.peer_lost_error
                self._log_quarantines(iteration, state, dead)
                if profile is not None and steps_done >= profile_stop_at:
                    self._stop_profile(profile, t)
                    profile = None
                if (
                    self._log_every_steps
                    and _crossed(prev_steps_done, steps_done, self._log_every_steps)
                    and coordination.is_chief()
                ):
                    emas = iteration.ema_losses(state)
                    _LOG.info(
                        "iteration %d step %d/%d adanet_loss EMAs: %s",
                        t, steps_done, self._max_iteration_steps,
                        {k: round(v, 6) for k, v in emas.items()},
                    )
                    if self._enable_summaries:
                        self._write_train_summaries(iteration, metrics, emas, state, info.global_step)
                if self._save_checkpoint_steps and _crossed(prev_steps_done, steps_done, self._save_checkpoint_steps):
                    if multihost:
                        if executor.lost_peers:
                            # Unreachable groups would be checkpointed at
                            # their initial parameters, without their dead
                            # marks (forced at the iteration's end): keep
                            # the previous checkpoint.
                            _LOG.warning(
                                "Skipping mid-iteration checkpoint at global step %d: a peer is lost.",
                                info.global_step,
                            )
                        else:
                            # Every process joins the gather; the chief writes.
                            host_state = executor.gather(state)
                            if coordination.is_chief():
                                self._save_iteration_state(info, t, host_state)
                    elif coordination.is_chief():
                        self._save_iteration_state(info, t, state)
            if profile is not None:
                self._stop_profile(profile, t)
            # The bagged streams end with their iteration: their prefetch
            # workers are closed now, not when train() returns.
            for extra_iter in extra_iters.values():
                self._close_iter(extra_iter)
            if executor is not None:
                state = executor.gather(state)
                dead = executor.dead_candidate_names()
                if dead:
                    # Faulted candidates join the NaN-quarantine path.
                    for name in dead:
                        state.candidates[name].dead = torch.ones_like(state.candidates[name].dead)
                    _LOG.warning(
                        "Iteration %d completing with quarantined candidates excluded from selection: %s",
                        t, sorted(dead),
                    )
                if multihost and executor.lost_peers:
                    self._peer_lost = self._peer_lost or executor.peer_lost_error
            if steps_done < self._max_iteration_steps:
                # Stopped inside the iteration (max_steps or SIGTERM):
                # persist the state; a fresh process resumes from here.
                if coordination.is_chief():
                    self._save_iteration_state(info, t, state)
                if self._stop_requested:
                    _LOG.warning(
                        "Stopped by SIGTERM at global step %d (iteration %d, step %d); state checkpointed.",
                        info.global_step, t, steps_done,
                    )
                break
            if self._peer_lost is not None and self._process_group is None:
                # Degraded mode: the chief keeps the books on its own (the
                # lost groups' candidates are quarantined) and the search
                # stops at this boundary; a restart re-forms the cluster
                # and resumes from the durable state.
                if coordination.is_chief():
                    self._previous = self._complete_iteration(iteration, state, sample_batch, info)
                _LOG.error(
                    "Stopping the search after iteration %d (%s). All surviving candidates finished and the "
                    "checkpoint is durable; restart to re-form the cluster and resume.", t, self._peer_lost,
                )
                break
            if self._process_group is not None:
                # Data-parallel bookkeeping: every process selects (the
                # Evaluator and the reports are collective) and freezes
                # the same winner; the chief alone writes, and the workers
                # then wait for its manifest.
                self._previous = self._complete_iteration(
                    iteration, state, sample_batch, info, write=coordination.is_chief()
                )
                if not coordination.is_chief():
                    info = coordination.wait_for_iteration(
                        self._model_dir, t + 1, timeout_secs=self._worker_wait_timeout_secs,
                        heartbeat_timeout_secs=watchdog_lib.heartbeat_timeout_secs(),
                    )
            elif coordination.is_chief():
                self._previous = self._complete_iteration(iteration, state, sample_batch, info)
            else:
                # A worker of its own process: the chief's bookkeeping
                # decides; the next iteration rebuilds its winner from disk.
                info = coordination.wait_for_iteration(
                    self._model_dir, t + 1, timeout_secs=self._worker_wait_timeout_secs,
                    heartbeat_timeout_secs=(
                        watchdog_lib.heartbeat_timeout_secs() if coordination.process_count() > 1 else None
                    ),
                )
                self._previous = None

    def _should_stop(self) -> bool:
        """The stop decision, agreed across processes: a SIGTERM may land
        between the checks of different processes, so every process puts
        its flag into the store at the same boundaries and all stop if
        any was signalled (a store round trip, never a device collective,
        so that a dead peer raises instead of wedging the stop)."""
        if not self._collective or self._peer_lost is not None:
            return self._stop_requested
        try:
            flags = coordination.allgather_host_flag(int(self._stop_requested), label="stop")
        except watchdog_lib.PeerLostError as exc:
            _LOG.error("Peer lost at the stop agreement: %s", exc)
            self._peer_lost = exc
            return True
        return bool(max(flags))

    def _stop_check_interval(self) -> int:
        """Steps between agreed stop checks inside an iteration: the
        logging period (8 windows without logging), at least a window and
        at most 64 windows, so that a SIGTERM's checkpoint stays prompt."""
        interval = self._log_every_steps or 8 * self._iterations_per_loop
        return max(self._iterations_per_loop, min(interval, 64 * self._iterations_per_loop))

    def _should_stop_at(self, steps_done: int) -> bool:
        """The in-loop stop check: the local flag every window in one
        process; across processes the agreement, when `steps_done` crosses
        the check interval (the same arithmetic on every process)."""
        if not self._collective or self._peer_lost is not None:
            return self._stop_requested
        if steps_done - self._last_stop_check_step < self._stop_check_interval():
            return False
        self._last_stop_check_step = steps_done
        return self._should_stop()

    # ------------------------------------------------- elastic work queue

    def _drain_elastic_iteration(self, executor, iteration, state, info, t, steps_done, max_steps, input_fn):
        """One iteration as a work-queue drain (`distributed/scheduler.py`).

        Returns the state and the updated iteration-local step count;
        `info.global_step` advances by the ensemble steps the drain
        completed, the lockstep accounting. On workers the returned state
        is the entry state: the books are the chief's, and workers wait
        on the manifest."""
        strategy = self._placement_strategy
        target = self._max_iteration_steps
        if max_steps is not None:
            target = min(target, steps_done + max(0, max_steps - info.global_step))
        if self._elastic_batches is None:
            self._elastic_batches = _BatchLog(lambda: self._make_train_iter(input_fn), close_iter=self._close_iter)
        batch_log = self._elastic_batches
        first_global = info.global_step - steps_done
        batch_log.forget_below(first_global)
        self._elastic_epoch += 1
        namespace = "adanet/wq/e%d/t%d/s%d" % (self._elastic_epoch, t, steps_done)
        warm = self._take_speculation(t, iteration.previous_ensemble)
        result = executor.run_iteration(
            state,
            batch_log.batch_at,
            first_global_step=first_global,
            target_steps=target,
            queue_namespace=namespace,
            should_stop=lambda: self._stop_requested,
            warm_states=warm,
            forget_below=batch_log.forget_below,
        )
        if result.state is not None:
            state = result.state
        steps_done += result.steps_trained
        info.global_step += result.steps_trained
        if self._log_every_steps and result.steps_trained and coordination.is_chief():
            emas = iteration.ema_losses(state)
            _LOG.info(
                "iteration %d step %d/%d (elastic drain: %d dispatched, %d reused) adanet_loss EMAs: %s",
                t, steps_done, self._max_iteration_steps, result.dispatched_steps, result.reused_steps,
                {k: round(v, 6) for k, v in emas.items()},
            )
        if (
            result.completed
            and coordination.is_chief()
            and strategy.speculate_steps > 0
            and steps_done >= self._max_iteration_steps
            and (self._max_iterations is None or t + 1 < self._max_iterations)
            and (max_steps is None or info.global_step < max_steps)
        ):
            self._speculate_next_iteration(t, iteration, state, batch_log, info.global_step)
        return state, steps_done

    def _take_speculation(self, t, previous):
        """Warm window states for iteration `t`, or None.

        The speculative winner must MATCH the actually selected previous
        ensemble; on a flip (an Evaluator, `force_grow`, or replay chose
        differently) the warm states are discarded — they were trained
        against the wrong teacher."""
        spec, self._speculation = self._speculation, None
        if spec is None or previous is None or spec["iteration"] != t:
            return None
        if spec["previous_name"] != previous.name:
            _LOG.info(
                "Discarding speculative warm start for iteration %d: winner flipped (%s -> %s).",
                t, spec["previous_name"], previous.name,
            )
            return None
        return spec["states"]

    def _speculate_next_iteration(self, t, iteration, state, batch_log, next_global_step):
        """Pre-trains iteration t+1's candidates against the LIKELY
        winner (EMA argmin), subnetworks only, stashing per-window warm
        states keyed by the speculated winner (chief-local, in memory).
        Off beside a `report_materializer` (t+1's generator would read
        reports the bookkeeping has not written yet); a failure is
        logged and never raised."""
        from adanet_tpu_torch.distributed.scheduler import ElasticWorkQueueExecutor, InMemoryKV

        strategy = self._placement_strategy
        spec_target = strategy.speculate_steps // strategy.window_steps * strategy.window_steps
        spec_target = min(spec_target, self._max_iteration_steps)
        if spec_target <= 0 or self._report_materializer is not None:
            return
        try:
            likely = iteration.best_candidate_index(state)
        except FloatingPointError:
            return  # every candidate dead: nothing to speculate against
        likely_name = iteration.candidate_names()[likely]
        sample = batch_log.batch_at(next_global_step)
        try:
            frozen_guess = iteration.freeze_candidate(state, likely_name, sample)
            builders = self._generate_builders(t + 1, frozen_guess)
            next_iteration = self._iteration_builder.build_iteration(
                t + 1, builders, frozen_guess, input_shape=feature_shape(self._model_features(sample[0]))
            )
            spec_state = next_iteration.init_state(self._iteration_generator(t + 1), sample)
            spec_executor = ElasticWorkQueueExecutor(next_iteration, strategy, kv=InMemoryKV())
            result = spec_executor.run_iteration(
                spec_state,
                batch_log.batch_at,
                first_global_step=next_global_step,
                target_steps=spec_target,
                queue_namespace="adanet/wq/spec/t%d" % (t + 1),
                subnetworks_only=True,
            )
        except Exception as exc:
            # Speculation is an optimization; it must never take the
            # real search down with it.
            _LOG.warning("Speculative training for iteration %d failed (continuing without warm start): %s",
                         t + 1, exc)
            return
        self._speculation = {"iteration": t + 1, "previous_name": frozen_guess.name,
                             "states": result.window_states}
        _LOG.info("Speculatively trained %d steps of iteration %d's %d candidates against likely winner %r.",
                  result.dispatched_steps, t + 1, len(next_iteration.subnetwork_specs), frozen_guess.name)

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

    def _close_iter(self, data_iter) -> None:
        """Closes `data_iter`'s prefetch worker, if it has one."""
        if isinstance(data_iter, _Prepended):
            data_iter = data_iter.source
        if any(data_iter is p for p in self._open_prefetchers):
            data_iter.close()
            self._open_prefetchers[:] = [p for p in self._open_prefetchers if p is not data_iter]

    def _next_batch(self, input_fn, data_iter, attempts: int = 3):
        """The next batch, calling `input_fn` again at the end of its
        iterator; a transient data-source failure re-opens the pipeline
        (at most `attempts` pulls)."""
        for attempt in range(attempts):
            if data_iter is None:
                data_iter = self._make_train_iter(input_fn)
            try:
                faults_lib.trip("data.pull")
                batch = next(data_iter)
            except StopIteration:
                # The stream ended: its prefetcher goes before the next
                # epoch's opens.
                self._close_iter(data_iter)
                data_iter = self._make_train_iter(input_fn)
                try:
                    batch = next(data_iter)
                except StopIteration:
                    raise ValueError("input_fn yielded no batches.")
            except Exception as exc:
                if attempt == attempts - 1 or not retry_lib.is_transient(exc):
                    raise
                _LOG.warning(
                    "Transient data-source failure (pull attempt %d/%d): %s; re-opening the "
                    "input pipeline.", attempt + 1, attempts, exc,
                )
                if data_iter is not None:
                    self._close_iter(data_iter)
                data_iter = None
                continue
            self._stash_calibration_batch(batch)
            return batch, data_iter
        raise AssertionError("unreachable")  # pragma: no cover

    #: Every Nth data pull feeds the cascade-calibration reservoir, sparse
    #: enough that the host copy never shows on the step time.
    _CALIBRATION_STRIDE = 16

    def _stash_calibration_batch(self, batch) -> None:
        """Feeds the publish-time cascade-calibration reservoir: the last
        `cascade_calibration_batches` sampled feature batches, as host
        copies (a device batch may be reused by the step). A no-op
        unless serving export and the cascade are both on."""
        if not (self._export_serving and self._serving_cascade):
            return
        self._calibration_pulls += 1
        if (self._calibration_pulls - 1) % self._CALIBRATION_STRIDE:
            return
        try:
            features = batch[0] if isinstance(batch, tuple) else batch
            features = _host_tree(features)
        except Exception:
            _LOG.warning("Cascade calibration stash failed; publish-time calibration falls back to the sample "
                         "batch.", exc_info=True)
            return
        self._cascade_calibration.append(features)
        excess = len(self._cascade_calibration) - self._cascade_calibration_batches
        if excess > 0:
            del self._cascade_calibration[:excess]

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
        iteration = self._iteration_builder.build_iteration(
            iteration_number, builders, previous, input_shape=feature_shape(self._model_features(sample_batch[0]))
        )
        iteration.set_process_group(self._process_group)
        return iteration

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
        payload = None
        try:
            payload = ckpt_lib.restore_payload(self._model_dir, info.iteration_state_file)
        except (ckpt_lib.CheckpointCorruptionError, OSError) as exc:
            # OSError covers the multi-process race where the chief's heal
            # just quarantined the file out from under this process.
            _LOG.error(
                "Mid-iteration state corrupt at restore time (%s); rolling back to the start of iteration %d.",
                exc, info.iteration_number,
            )
        failed = payload is None
        if training and coordination.process_count() > 1:
            # The verdict is collective: one process rolling back alone
            # (only its read hit the rot) would train from a fresh init
            # at another global step than its peers. All roll back if
            # any failed.
            try:
                failed = bool(max(coordination.allgather_host_flag(int(failed), label="restore agreement")))
            except watchdog_lib.PeerLostError as exc:
                _LOG.error("Peer lost at the restore agreement: %s", exc)
                self._peer_lost = exc  # degrade; the local verdict stands
        if failed:
            stale = info.iteration_state_file
            info.iteration_state_file = None
            info.global_step = integrity.end_step_of(info, self._model_dir, info.iteration_number)
            if coordination.is_chief():
                ckpt_lib.quarantine_file(self._model_dir, stale)
                ckpt_lib.write_manifest(self._model_dir, info)
            return state
        iteration_lib.restore_state(state, payload, restore_generator=training)
        _LOG.info("Restored mid-iteration state from %s", info.iteration_state_file)
        return state

    def _save_iteration_state(self, info, iteration_number, state) -> None:
        with spans_lib.tracer().span(
            "checkpoint.save", correlation={"iteration": iteration_number}, global_step=info.global_step
        ):
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
        """The reference's selection: the `replay_config`'s recorded index
        for iteration t when it has one, else the Evaluator's objective
        over its values when there is an Evaluator, else the EMA argmin;
        with `force_grow` at t>0 the carried-over ensemble is left out."""
        self._last_selection_values = None
        if self._replay_config:
            index = self._replay_config.get_best_ensemble_index(iteration.iteration_number)
            if index is not None:
                return int(index)
        if len(iteration.ensemble_specs) == 1:
            return 0
        exclude_first = self._force_grow and iteration.iteration_number > 0
        if self._evaluator:
            # Only a collective pass takes the keyword, so that an
            # Evaluator subclass of the single-process signature works.
            collective = {"collective": True} if iteration.process_group is not None else {}
            values = self._evaluator.evaluate(iteration, state, **collective)
            self._last_selection_values = [float(v) for v in values]
            objective_fn = self._evaluator.objective_fn
            if exclude_first:
                return int(objective_fn(values[1:])) + 1
            return int(objective_fn(values))
        return iteration.best_candidate_index(state, exclude_first=exclude_first)

    def _complete_iteration(self, iteration, state, sample_batch, info, write: bool = True) -> FrozenEnsemble:
        """Selects and freezes the winner; writes
        `candidate-metrics-<t>.json`, every candidate's final state with
        `keep_candidate_states`, `architecture-<t>.json`, the frozen
        payload, the subnetworks' reports with a `report_materializer`,
        and the manifest of iteration t+1 (history, replay indices, the
        generation bump), then drops the iteration's state file. Without
        `write` (a data-parallel worker) only the in-memory results: the
        selection and reports still run, collectively."""
        with spans_lib.tracer().span(
            "iteration.complete", correlation={"iteration": iteration.iteration_number}, write=write
        ):
            return self._complete_iteration_impl(iteration, state, sample_batch, info, write)

    def _complete_iteration_impl(self, iteration, state, sample_batch, info, write: bool = True) -> FrozenEnsemble:
        t = iteration.iteration_number
        best_index = self._get_best_ensemble_index(iteration, state)
        spec = iteration.ensemble_specs[best_index]
        _LOG.info("Iteration %d best ensemble: %s (index %d)", t, spec.name, best_index)
        frozen = iteration.freeze_candidate(state, spec.name, sample_batch)
        frozen.architecture.add_replay_index(best_index)
        frozen.architecture.set_global_step(info.global_step)
        if write:
            self._write_candidate_metrics(iteration, state, best_index, info)
        if write and self._keep_candidate_states:
            final_name = ckpt_lib.final_state_filename(t)
            info.digests[final_name] = ckpt_lib.save_payload(
                self._model_dir, final_name, iteration_lib.state_payload(state)
            )
        if write:
            ckpt_lib.write_text(self._model_dir, ckpt_lib.architecture_filename(t), frozen.architecture.serialize())
            frozen_name = ckpt_lib.frozen_filename(t)
            info.digests[frozen_name] = ckpt_lib.save_payload(
                self._model_dir, frozen_name, ckpt_lib.frozen_to_payload(frozen)
            )
        if self._report_materializer:
            included = [ws.subnetwork.name for ws in frozen.weighted_subnetworks if ws.subnetwork.iteration_number == t]
            collective = {"collective": True} if iteration.process_group is not None else {}
            reports = self._report_materializer.materialize_subnetwork_reports(iteration, state, included, **collective)
            if write:
                self._report_accessor.write_iteration_report(t, reports)
        stale_state = info.iteration_state_file
        info.iteration_number = t + 1
        info.iteration_state_file = None
        info.replay_indices = frozen.architecture.replay_indices
        info.history.append(
            {"iteration_number": t, "global_step": int(info.global_step), "generation": info.generation + 1}
        )
        if write:
            if self._artifact_store is not None:
                # Before the manifest write, so that the manifest's
                # `store_refs` entry rides this generation.
                self._store_publish_iteration(t, info)
            ckpt_lib.write_manifest(self._model_dir, info)
            self._remove_state_file(stale_state)
            # replay.json after every completed iteration, so that an
            # interrupted search stays replayable up to here.
            self._write_replay_record()
            if self._export_serving:
                self._publish_serving_generation(t, frozen, sample_batch)
        if self._summary is not None:
            self._summary.close()
        return frozen

    def _write_replay_record(self) -> None:
        """Writes `replay.json`, derived afresh from the manifest and the
        architecture files (so a rolled-back or resumed search never
        keeps a stale record); a failure is logged, never raised."""
        try:
            config = replay_lib.Config.from_model_dir(self._model_dir, prefer_recorded=False)
            if config.num_iterations:
                config.save(os.path.join(self._model_dir, replay_lib.REPLAY_FILENAME))
        except Exception:
            _LOG.exception("Could not write the replay record; the search result itself is unaffected.")

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
        if not self._enable_summaries:
            return
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
        moves to the CPU otherwise. With `debug`, every batch is checked
        for non-finite floats before the model sees it."""
        data = iter(input_fn())
        if self._debug:
            data = _checked(data)
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
                predictions = self._predictions_with_member_outputs(forward(features))
            yield {key: _cpu_tree(value) for key, value in predictions.items()}

    def _predictions_with_member_outputs(self, ensemble):
        """The head's predictions, plus every member's outputs when the
        `export_subnetwork_*` flags are set (for `predict` and the
        exported program)."""
        out = self._head.predictions(ensemble.logits)
        members = getattr(ensemble, "subnetworks", None) or []
        for i, member in enumerate(members):
            if self._export_subnetwork_logits:
                out["subnetwork_logits/%d" % i] = member.logits
            if self._export_subnetwork_last_layer:
                out["subnetwork_last_layer/%d" % i] = member.last_layer
        return out

    # ---------------------------------------------------------------- export

    def export_saved_model(self, export_dir: str, sample_batch, serialize_program: bool = True) -> str:
        """Exports the final frozen ensemble for serving.

        Writes (a) the durable state, `architecture.json` and the frozen
        payload `ensemble.pt` (reloadable with the same deterministic
        generator), and (b) with `serialize_program`, a hermetic
        `torch.export` program of the whole prediction function with the
        parameters inside (`core/export.py`, `serving.pt2`), which a
        process serves with no model code. `sample_batch` is (features,
        labels) or features."""
        info = ckpt_lib.read_manifest(self._model_dir)
        if info is None or info.iteration_number == 0:
            raise ValueError("Nothing to export; train first.")
        features = sample_batch[0] if isinstance(sample_batch, tuple) else sample_batch
        frozen = self._rebuild_previous_ensemble(info.iteration_number, (features, None))
        os.makedirs(export_dir, exist_ok=True)
        with open(os.path.join(export_dir, "architecture.json"), "w") as f:
            f.write(frozen.architecture.serialize())
        payload = ckpt_lib.frozen_to_payload(frozen)
        payload["name"] = frozen.name
        payload["iteration_number"] = frozen.iteration_number
        ckpt_lib.save_payload(export_dir, "ensemble.pt", payload)
        if serialize_program:
            from adanet_tpu_torch.core import export as export_lib

            export_lib.export_serving_program(
                export_dir, self._frozen_predict_fn(frozen), features, device=self._device
            )
        return export_dir

    def _frozen_predict_fn(self, frozen):
        """`features -> predictions` of a frozen ensemble, its parameters
        closed over: what `export_saved_model` and the per-iteration
        publication export."""
        ensembler = self._iteration_builder._ensembler_by_name(frozen.ensembler_name)

        def predict_fn(features):
            features, _ = split_example_weights(features, self._weight_key, require=False)
            outs = frozen.member_outputs(features, training=False)
            ensemble = ensembler.build_ensemble(frozen.ensembler_params, outs)
            return self._predictions_with_member_outputs(ensemble)

        return predict_fn

    def _cheap_prefix_predict_fn(self, frozen, k: int = 1):
        """`features -> predictions` of the ensemble's first (cheapest) `k`
        members: a valid truncated ensemble, since members are frozen in
        cost order and the mixture weights align with them. The
        generation's auto-published cascade level 0."""
        ensembler = self._iteration_builder._ensembler_by_name(frozen.ensembler_name)
        params = frozen.ensembler_params
        if isinstance(params, dict) and isinstance(params.get("weights"), (list, tuple)):
            params = dict(params, weights=list(params["weights"])[:k])

        def predict_fn(features):
            features, _ = split_example_weights(features, self._weight_key, require=False)
            outs = frozen.member_outputs(features, training=False)[:k]
            ensemble = ensembler.build_ensemble(params, outs)
            return self._head.predictions(ensemble.logits)

        return predict_fn

    def _auto_cascade_spec(self, frozen, sample_features):
        """The generation's `CascadeSpec`, or None when a cascade cannot
        help: one member, per-member outputs (the trees would not be
        congruent), or a head without a categorical logits leaf.
        Calibration runs on the training reservoir, the sample batch
        standing in before the first stash."""
        from adanet_tpu_torch.serving.fleet import cascade as cascade_lib

        if len(frozen.weighted_subnetworks) < 2:
            return None
        if self._export_subnetwork_logits or self._export_subnetwork_last_layer:
            return None
        dimension = self._head.logits_dimension
        if not isinstance(dimension, int) or dimension < 2:
            return None
        probe = self._head.predictions(torch.zeros((1, dimension)))
        logits_key = "logits" if "logits" in probe else cascade_lib.DEFAULT_LOGITS_KEY
        if logits_key not in probe:
            return None
        batches = list(self._cascade_calibration) or [sample_features]

        def cat(*leaves):
            if isinstance(leaves[0], dict):
                return {key: cat(*(leaf[key] for leaf in leaves)) for key in leaves[0]}
            return np.concatenate([np.asarray(leaf) for leaf in leaves], axis=0)

        try:
            calibration = cat(*batches)
        except Exception:
            calibration = sample_features
        return cascade_lib.CascadeSpec(
            predict_fn=self._cheap_prefix_predict_fn(frozen),
            calibration_features=calibration,
            logits_key=logits_key,
            target_agreement=self._cascade_target_agreement,
            source="member",
        )

    def _publish_serving_generation(self, t, frozen, sample_batch):
        """The chief's failure-isolated serving export of iteration t,
        after the manifest write (a published `gen-<t>` is always a
        durably completed iteration), with the auto-derived cascade when
        `serving_cascade`. A failure is logged and the search goes on;
        serving stays on the previous generation."""
        from adanet_tpu_torch.serving import publisher

        try:
            features = sample_batch[0] if isinstance(sample_batch, tuple) else sample_batch
            features = _host_tree(features)
            cascade = None
            if self._serving_cascade:
                try:
                    cascade = self._auto_cascade_spec(frozen, features)
                except Exception:
                    _LOG.exception("Cascade spec derivation for generation %d failed; publishing without a "
                                   "cascade.", t)
            publisher.publish_generation(
                self._model_dir, t, self._frozen_predict_fn(frozen), features, store=self._artifact_store,
                cascade=cascade, device=self._device,
            )
        except Exception:
            _LOG.exception("Serving export for generation %d failed; the search continues and serving stays on "
                           "the previous generation.", t)

    # --------------------------------------------------------- artifact store

    #: The blob entry of a frozen ref naming the port's payload, and the
    #: ingredient that keys the port's refs apart from the JAX package's
    #: (whose entry is `frozen.msgpack`): the same architecture, seed and
    #: step budget are different bytes in the two packages.
    STORE_PAYLOAD_ENTRY = "frozen.pt"
    STORE_PAYLOAD_FORMAT = "adanet_tpu_torch/frozen.pt"

    def _store_lease_ttl_secs(self) -> float:
        """`ADANET_STORE_LEASE_TTL_SECS` (default 3600): how long this
        search's store pins outlive a crash before GC may reclaim them."""
        raw = os.environ.get("ADANET_STORE_LEASE_TTL_SECS", "").strip()
        if raw:
            try:
                return float(raw)
            except ValueError:
                _LOG.warning("Ignoring non-numeric ADANET_STORE_LEASE_TTL_SECS=%r.", raw)
        return 3600.0

    def _store_spec_fingerprint(self) -> str:
        """What makes different frozen payloads under the same
        architecture: the seed and the step budget, `store_spec_extra`,
        and the payload format. Two searches agreeing on all of it (and
        on the architecture hash) train bit-identical members."""
        from adanet_tpu_torch.store import keys as store_keys

        extra = dict(self._store_spec_extra or {})
        if "payload_format" in extra:
            raise ValueError("store_spec_extra may not set 'payload_format': it keys the port's refs apart")
        extra["payload_format"] = self.STORE_PAYLOAD_FORMAT
        return store_keys.search_spec_fingerprint(self._random_seed, self._max_iteration_steps, extra)

    def _frozen_ref_name(self, arch_hash: str, t: int) -> str:
        """`frozen/<arch_hash>-t<t>-<spec>`: the iteration is part of the
        key, because a re-selected winner has its previous iteration's
        structural hash but other numbers (its mixture weights trained
        further)."""
        from adanet_tpu_torch.store import keys as store_keys

        return store_keys.ref_name(arch_hash, "t%d" % int(t), self._store_spec_fingerprint())

    def _store_lease_pin(self, digests) -> None:
        """Adds digests to this search's lease and extends its TTL."""
        if self._store_lease is None:
            return
        from adanet_tpu_torch.store import leases as store_leases

        try:
            store_leases.renew(self._artifact_store, self._store_lease, self._store_lease_ttl_secs(),
                               add_digests=digests)
        except store_leases.LeaseExpiredError:
            # The pin lapsed and GC may have swept in the gap: acquire the
            # whole closure anew rather than revive the dead lease.
            self._store_lease = store_leases.acquire(
                self._artifact_store, owner="search-%d" % os.getpid(), ttl_secs=self._store_lease_ttl_secs(),
                digests=sorted(set(self._store_lease.digests) | set(digests)),
            )
        except OSError as exc:
            _LOG.warning("Store lease renewal failed: %s", exc)

    def _store_publish_iteration(self, t: int, info) -> None:
        """Publishes iteration t's frozen winner: one ref binding the
        architecture file and the frozen payload, with the model dir's
        copies recorded as heal sources. Failure-isolated: a store outage
        means no sharing, never a dead search."""
        frozen_name = ckpt_lib.frozen_filename(t)
        arch_path = os.path.join(self._model_dir, ckpt_lib.architecture_filename(t))
        frozen_path = os.path.join(self._model_dir, frozen_name)
        try:
            from adanet_tpu_torch.store import keys as store_keys

            with open(arch_path, "rb") as f:
                arch_bytes = f.read()
            with open(frozen_path, "rb") as f:
                frozen_bytes = f.read()
            store = self._artifact_store
            arch_digest = store.put(arch_bytes)
            frozen_digest = store.put(frozen_bytes)
            ref = store.put_ref(
                "frozen",
                self._frozen_ref_name(store_keys.architecture_hash(json.loads(arch_bytes)), t),
                {"architecture.json": arch_digest, self.STORE_PAYLOAD_ENTRY: frozen_digest},
                meta={"iteration_number": int(t), "global_step": int(info.global_step)},
                sources=[arch_path, frozen_path],
            )
            info.store_refs[frozen_name] = ref["blobs"].get(self.STORE_PAYLOAD_ENTRY, frozen_digest)
            self._store_lease_pin(sorted(set(ref["blobs"].values())))
        except Exception:
            _LOG.exception("Store publication for iteration %d failed; the search continues without sharing it.", t)

    def _store_reconcile(self, info) -> None:
        """The chief's start: publishes again each completed iteration
        whose ref is missing (a crash between the artifact and the ref
        writes, or a store given to a model dir trained without one),
        and, with `export_serving`, each generation's closure (a
        publisher killed mid-closure; the puts heal a torn blob)."""
        from adanet_tpu_torch.store import keys as store_keys

        for t in range(info.iteration_number):
            arch_path = os.path.join(self._model_dir, ckpt_lib.architecture_filename(t))
            if not (os.path.exists(arch_path) and os.path.exists(os.path.join(self._model_dir,
                                                                             ckpt_lib.frozen_filename(t)))):
                continue  # fsck owns broken chains
            try:
                arch_hash = store_keys.architecture_hash_from_file(arch_path)
            except (OSError, ValueError):
                continue
            try:
                missing = self._artifact_store.get_ref("frozen", self._frozen_ref_name(arch_hash, t)) is None
            except Exception:
                _LOG.exception("Store ref read for iteration %d failed.", t)
                continue
            if missing:
                self._store_publish_iteration(t, info)
        if self._export_serving:
            from adanet_tpu_torch.serving import publisher

            for t, _ in publisher.list_generations(self._model_dir):
                publisher.publish_ref_closure(self._artifact_store, self._model_dir, t)

    def _try_store_replay(self, t: int, info) -> bool:
        """Grafts iteration t from the store when the replay config
        records its winner there: no batch, no training step, no kernel
        launch. False (train it instead) whenever anything is missing."""
        if (
            self._replay_config is None
            or self._artifact_store is None
            or not coordination.is_chief()
            or coordination.process_count() > 1
        ):
            return False
        get_hash = getattr(self._replay_config, "get_architecture_hash", None)
        arch_hash = get_hash(t) if get_hash is not None else None
        if arch_hash is None:
            return False
        store = self._artifact_store
        from adanet_tpu_torch.store.blobstore import StoreError

        try:
            ref = store.get_ref("frozen", self._frozen_ref_name(arch_hash, t))
            if ref is None:
                return False
            blobs = ref.get("blobs", {})
            if not {"architecture.json", self.STORE_PAYLOAD_ENTRY} <= set(blobs):
                return False
            arch_bytes = store.get(blobs["architecture.json"])
            frozen_bytes = store.get(blobs[self.STORE_PAYLOAD_ENTRY])
        except (StoreError, OSError, ValueError) as exc:
            _LOG.warning("Warm start for iteration %d unavailable (%s); training it instead.", t, exc)
            return False
        arch_obj = json.loads(arch_bytes)
        # The artifacts land byte for byte as the trained iteration's did,
        # and the manifest advances as `_complete_iteration` advances it.
        frozen_name = ckpt_lib.frozen_filename(t)
        ckpt_lib.write_text(self._model_dir, ckpt_lib.architecture_filename(t), arch_bytes.decode())
        info.digests[frozen_name] = ckpt_lib.write_payload_bytes(self._model_dir, frozen_name, frozen_bytes)
        info.store_refs[frozen_name] = blobs[self.STORE_PAYLOAD_ENTRY]
        stale_state = info.iteration_state_file
        info.iteration_number = t + 1
        info.iteration_state_file = None
        info.replay_indices = list(arch_obj.get("replay_indices", []))
        info.global_step = int(arch_obj.get("global_step", info.global_step))
        info.history.append(
            {"iteration_number": t, "global_step": int(info.global_step), "generation": info.generation + 1}
        )
        ckpt_lib.write_manifest(self._model_dir, info)
        self._remove_state_file(stale_state)
        # As after a trained iteration: the graft is graftable in turn
        # even if this process dies before the search ends.
        self._write_replay_record()
        self._store_lease_pin(sorted(set(blobs.values())))
        if self._export_serving and not self._warned_replay_serving:
            # A graft has no trained state (and no sample batch) to export.
            self._warned_replay_serving = True
            _LOG.warning(
                "Warm-started iterations do not publish serving generations (no trained state to export); run "
                "export_saved_model after the replay, or continue the search past the replayed prefix."
            )
        self._store_graft_count += 1
        metrics_lib.registry().counter("estimator.replay.store_grafts").inc()
        _LOG.info("Iteration %d warm-started from the artifact store (architecture %s): no training.", t,
                  arch_hash[:12])
        return True
