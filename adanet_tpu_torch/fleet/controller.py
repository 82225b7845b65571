"""The fleet population controller: a search of searches.

Port of adanet_tpu/fleet/controller.py over the port's Estimator, lease
queue (`distributed.scheduler.drain_callables`), store and replay. The
controller takes a `device` (the card by default): every trial, its
scoring and the champion run there, one queue worker a slot on it.

`FleetController` runs N concurrent `Estimator` searches (trials) over
ONE shared content-addressed artifact store, under a successive-halving
rung schedule:

- **Rungs.** `rung_iterations = (r0, r1, ...)` are CUMULATIVE AdaNet
  iteration budgets. Rung k trains every live trial from its current
  checkpoint up to `rung_iterations[k]` completed iterations. Trials
  run as work units through the lease-based callable queue
  (`distributed.scheduler.drain_callables`), so a fleet wider than its
  worker capacity packs in waves and a finishing trial's slot is
  IMMEDIATELY re-claimed by the next queued trial.
- **Promotion.** At each rung boundary every live trial's current best
  ensemble is scored by the comparator — the complexity-regularized
  AdaNet objective F(w) on one shared eval stream
  (`fleet/comparator.py`) — and only the top `survivor_fraction`
  survive to the next rung. Culled trials stop consuming capacity at
  once (they publish no units in later rungs), but their PUBLISHED
  artifacts remain live donors for cross-search grafting.
- **Transfer.** Whenever a trial (re)launches, `fleet/transfer.py`
  plans the longest replay prefix available from fingerprint-compatible
  donors — siblings, culled trials, dead incarnations of itself — and
  the launch grafts those iterations from the store with zero training
  steps and zero kernel launches. The final **champion rebuild** is the
  same mechanism end-to-end: the winner's search is replayed into a
  fresh `champion/` dir purely from store grafts, which both yields the
  fleet's canonical exportable artifact and proves cross-search payload
  reuse (`fleet.graft.hits`).
- **Crash safety.** Fleet state (`fleet.json`) is written atomically
  after every phase; trial progress is ordinary Estimator checkpoint
  state plus the per-iteration incremental `replay.json`. A controller
  SIGKILLed anywhere — the `fleet.promote` fault site sits on the
  promotion seam — resumes by re-running `run()` over the same work
  dir: completed rungs are skipped, culled trials stay culled, and a
  half-trained rung resumes from each trial's checkpoint.

Observability: a `fleet` span (correlation `fleet_id`) over `rung`,
trial-run, and champion spans; `fleet.trials.{launched,culled,
promoted}` and `fleet.graft.{attempts,hits}` counters; flight-recorder
dumps on trial failure.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import os
import time
import uuid
from typing import Dict, List, Optional, Sequence, Tuple

from adanet_tpu_torch._device import resolve_device
from adanet_tpu_torch.core import checkpoint as ckpt_lib
from adanet_tpu_torch.observability import flightrec as flightrec_lib
from adanet_tpu_torch.observability import metrics as metrics_lib
from adanet_tpu_torch.observability import spans as spans_lib
from adanet_tpu_torch.robustness import faults as faults_lib

from adanet_tpu_torch.fleet import comparator as comparator_lib
from adanet_tpu_torch.fleet import transfer as transfer_lib
from adanet_tpu_torch.fleet.trial import TrialSpec

_LOG = logging.getLogger("adanet_tpu_torch")

#: Durable fleet state, written atomically after every phase.
STATE_FILENAME = "fleet.json"
_STATE_VERSION = 1

#: Trial lifecycle states.
LIVE = "live"
CULLED = "culled"
FAILED = "failed"


@dataclasses.dataclass
class TrialRecord:
    """Mutable fleet-side state of one trial."""

    spec: TrialSpec
    model_dir: str
    state: str = LIVE
    rung: int = -1  # last COMPLETED rung (-1: none)
    attempt: int = 0  # respawn count (fresh dir per respawn)
    iterations: int = 0
    steps_trained: int = 0  # batches actually pulled (graft-free cost)
    grafted_iterations: int = 0
    train_secs: float = 0.0
    score: Optional[comparator_lib.Score] = None
    error: Optional[str] = None
    launched: bool = False

    def to_json(self) -> dict:
        return {
            "state": self.state,
            "rung": self.rung,
            "attempt": self.attempt,
            "model_dir": self.model_dir,
            "iterations": self.iterations,
            "steps_trained": self.steps_trained,
            "grafted_iterations": self.grafted_iterations,
            "train_secs": round(self.train_secs, 3),
            "score": self.score.to_json() if self.score else None,
            "error": self.error,
            "launched": self.launched,
            "spec": self.spec.summary(),
        }


@dataclasses.dataclass
class FleetReport:
    """The outcome of a completed fleet run.

    `graft_hits` is DURABLE (summed from per-trial records plus the
    persisted champion grafts, so a crash-resumed fleet reports the
    whole run); `graft_attempts` is a process-local telemetry delta and
    covers only the final process. `compile_store_hits` is always 0:
    the JAX package counts compiled programs found in the store, and
    the port runs eager with no compile cache (its kernels are nvcc
    libraries, built once a checkout), so it has none to count; the
    field stays so that both packages' reports read alike.
    """

    fleet_id: str
    winner_id: Optional[str]
    winner_score: Optional[comparator_lib.Score]
    champion_dir: Optional[str]
    total_steps_trained: int
    graft_attempts: int
    graft_hits: int
    compile_store_hits: int
    trials: Dict[str, dict]
    complete: bool

    def to_json(self) -> dict:
        return {
            "fleet_id": self.fleet_id,
            "winner_id": self.winner_id,
            "winner_score": (
                self.winner_score.to_json() if self.winner_score else None
            ),
            "champion_dir": self.champion_dir,
            "total_steps_trained": self.total_steps_trained,
            "graft_attempts": self.graft_attempts,
            "graft_hits": self.graft_hits,
            "compile_store_hits": self.compile_store_hits,
            "trials": self.trials,
            "complete": self.complete,
        }


class FleetController:
    """Runs a population of AdaNet searches over one shared store.

    Args:
      trials: the population's `TrialSpec`s (unique ids).
      input_fn: zero-arg callable yielding training batches; shared by
        every trial (per-trial data would belong in the spec's
        fingerprint).
      work_dir: fleet root — `fleet.json`, `trials/<id>/`, `champion/`,
        `flightrec/` live here.
      artifact_store: the SHARED store (an `ArtifactStore` or a root
        path); created under `work_dir/store` when None.
      rung_iterations: cumulative per-rung iteration budgets, strictly
        increasing.
      survivor_fraction: fraction (rounded up, min 1) of live trials
        promoted at each rung boundary but the last.
      comparator: a `comparator.Comparator`; built from `eval_input_fn`
        (default: `input_fn`) and `eval_steps` when None.
      workers: concurrent trial slots (the submesh analogue on one
        host: culled trials stop claiming slots, so freed capacity
        re-packs onto survivors). Note the flight recorder is a
        process-wide default rebound by each Estimator to its own
        model dir: with workers > 1, a MID-RUNG fault dump lands under
        whichever concurrent trial's dir bound it last (still on disk,
        possibly misfiled); the controller rebinds to the fleet's own
        `flightrec/` before every promotion and failure dump.
      max_trial_attempts: launches per trial (1 = no respawn). A failed
        trial respawns into a FRESH dir and grafts its dead
        incarnation's published progress back from the store.
      build_champion: replay the winner into `champion/` at the end.
      clock: injectable monotonic clock for runtime bookkeeping
        (mocked-clock tests).
      kv: injectable KV for the callable queue (None = fresh in-memory
        KV per rung).
      device: where every trial trains and is scored, and the queue's
        one device (the card by default; a CUDA request without CUDA
        raises).
    """

    def __init__(
        self,
        trials: Sequence[TrialSpec],
        input_fn,
        work_dir: str,
        artifact_store=None,
        rung_iterations: Sequence[int] = (1, 2),
        survivor_fraction: float = 0.5,
        comparator: Optional[comparator_lib.Comparator] = None,
        eval_input_fn=None,
        eval_steps: int = 8,
        workers: int = 1,
        max_trial_attempts: int = 2,
        build_champion: bool = True,
        clock=None,
        kv=None,
        device=None,
    ):
        self._device = resolve_device(device)
        if not trials:
            raise ValueError("A fleet needs at least one trial.")
        ids = [spec.trial_id for spec in trials]
        if len(set(ids)) != len(ids):
            raise ValueError("Duplicate trial ids: %r" % (sorted(ids),))
        rungs = [int(r) for r in rung_iterations]
        if not rungs or any(
            b <= a for a, b in zip(rungs, rungs[1:])
        ) or rungs[0] <= 0:
            raise ValueError(
                "rung_iterations must be positive and strictly "
                "increasing, got %r" % (rung_iterations,)
            )
        if not 0.0 < survivor_fraction <= 1.0:
            raise ValueError("survivor_fraction must be in (0, 1].")
        if workers < 1:
            raise ValueError("workers must be >= 1.")
        if max_trial_attempts < 1:
            raise ValueError("max_trial_attempts must be >= 1.")
        self._input_fn = input_fn
        self._work_dir = os.path.abspath(work_dir)
        os.makedirs(self._work_dir, exist_ok=True)
        from adanet_tpu_torch.store import ArtifactStore

        if artifact_store is None:
            artifact_store = os.path.join(self._work_dir, "store")
        self._store = (
            artifact_store
            if isinstance(artifact_store, ArtifactStore)
            else ArtifactStore(str(artifact_store))
        )
        self._rungs = rungs
        self._survivor_fraction = float(survivor_fraction)
        self._comparator = comparator or comparator_lib.Comparator(
            eval_input_fn or input_fn, eval_steps=eval_steps
        )
        self._workers = int(workers)
        self._max_trial_attempts = int(max_trial_attempts)
        self._build_champion = bool(build_champion)
        self._clock = clock or time.monotonic
        self._kv = kv
        self._records: Dict[str, TrialRecord] = {}
        for spec in trials:
            self._records[spec.trial_id] = TrialRecord(
                spec=spec, model_dir=self._trial_dir(spec.trial_id, 0)
            )
        self._fleet_id = "fleet-%s" % uuid.uuid4().hex[:8]
        self._next_rung = 0
        self._winner_id: Optional[str] = None
        self._champion_dir: Optional[str] = None
        # Champion grafts are not attributable to any trial record;
        # persisted in fleet.json so a resumed fleet's report keeps
        # honest graft accounting.
        self._champion_grafts = 0
        self._complete = False
        self._registry = metrics_lib.registry()

    # ------------------------------------------------------------ layout

    def _trial_dir(self, trial_id: str, attempt: int) -> str:
        name = trial_id if attempt == 0 else "%s.a%d" % (trial_id, attempt)
        return os.path.join(self._work_dir, "trials", name)

    @property
    def work_dir(self) -> str:
        return self._work_dir

    @property
    def store(self):
        return self._store

    # ------------------------------------------------------- durable state

    def _save_state(self) -> None:
        ckpt_lib.write_json(
            self._work_dir,
            STATE_FILENAME,
            {
                "version": _STATE_VERSION,
                "fleet_id": self._fleet_id,
                "rung_iterations": list(self._rungs),
                "survivor_fraction": self._survivor_fraction,
                "next_rung": self._next_rung,
                "winner": self._winner_id,
                "champion_dir": self._champion_dir,
                "champion_grafts": self._champion_grafts,
                "complete": self._complete,
                "trials": {
                    trial_id: record.to_json()
                    for trial_id, record in self._records.items()
                },
            },
        )

    def _load_state(self) -> bool:
        """Adopts a previous run's durable state; True when resumed."""
        state = load_status(self._work_dir)
        if state is None:
            return False
        if state.get("version") != _STATE_VERSION:
            raise ValueError(
                "Unsupported fleet state version %r in %s"
                % (state.get("version"), self._work_dir)
            )
        if list(state.get("rung_iterations", [])) != self._rungs:
            raise ValueError(
                "Resume with a different rung schedule (%r vs %r); use "
                "a fresh work dir to change the schedule."
                % (state.get("rung_iterations"), self._rungs)
            )
        self._fleet_id = state.get("fleet_id", self._fleet_id)
        self._next_rung = int(state.get("next_rung", 0))
        self._winner_id = state.get("winner")
        self._champion_dir = state.get("champion_dir")
        self._champion_grafts = int(state.get("champion_grafts", 0))
        self._complete = bool(state.get("complete", False))
        for trial_id, entry in state.get("trials", {}).items():
            record = self._records.get(trial_id)
            if record is None:
                raise ValueError(
                    "Fleet state in %s has trial %r this controller "
                    "was not constructed with." % (self._work_dir, trial_id)
                )
            recorded_fp = (entry.get("spec") or {}).get("spec_fingerprint")
            if recorded_fp and recorded_fp != record.spec.spec_fingerprint():
                raise ValueError(
                    "Trial %r resumed with a DIFFERENT spec "
                    "(fingerprint %s vs recorded %s) — grafts and "
                    "checkpoints would silently mix configurations."
                    % (
                        trial_id,
                        record.spec.spec_fingerprint(),
                        recorded_fp,
                    )
                )
            record.state = entry.get("state", LIVE)
            record.rung = int(entry.get("rung", -1))
            record.attempt = int(entry.get("attempt", 0))
            record.model_dir = entry.get("model_dir", record.model_dir)
            record.iterations = int(entry.get("iterations", 0))
            record.steps_trained = int(entry.get("steps_trained", 0))
            record.grafted_iterations = int(
                entry.get("grafted_iterations", 0)
            )
            record.train_secs = float(entry.get("train_secs", 0.0))
            record.error = entry.get("error")
            record.launched = bool(entry.get("launched", False))
            score = entry.get("score")
            if score:
                record.score = comparator_lib.Score(
                    trial_id=score["trial_id"],
                    objective=(
                        float("inf")
                        if score["objective"] is None
                        else float(score["objective"])
                    ),
                    loss=(
                        float("inf")
                        if score["loss"] is None
                        else float(score["loss"])
                    ),
                    complexity_regularization=float(
                        score["complexity_regularization"] or 0.0
                    ),
                    num_members=int(score["num_members"]),
                    iterations=int(score["iterations"]),
                    global_step=int(score["global_step"]),
                )
        missing = set(state.get("trials", {})) ^ set(self._records)
        if missing:
            raise ValueError(
                "Fleet state/controller trial mismatch: %r"
                % (sorted(missing),)
            )
        _LOG.info(
            "Fleet %s resumed at rung %d/%d from %s.",
            self._fleet_id,
            self._next_rung,
            len(self._rungs),
            self._work_dir,
        )
        return True

    # -------------------------------------------------------------- running

    def run(self) -> FleetReport:
        """Runs (or resumes) the fleet to completion."""
        flightrec_lib.install_default(
            os.path.join(self._work_dir, flightrec_lib.DEFAULT_SUBDIR)
        )
        self._load_state()
        graft_attempts0 = self._counter_value("fleet.graft.attempts")
        with spans_lib.tracer().span(
            "fleet",
            correlation={"fleet_id": self._fleet_id},
            trials=len(self._records),
            rungs=len(self._rungs),
        ):
            for rung in range(self._next_rung, len(self._rungs)):
                with spans_lib.tracer().span(
                    "fleet.rung",
                    correlation={"rung": rung},
                    target_iterations=self._rungs[rung],
                ):
                    self._run_rung(rung)
                    self._save_state()
                    self._promote(rung)
                self._next_rung = rung + 1
                self._save_state()
            if self._winner_id is None:
                self._pick_winner()
            if (
                self._build_champion
                and self._winner_id is not None
                and self._champion_dir is None
            ):
                self._champion_dir = self._run_champion()
            self._complete = True
            self._save_state()
        return FleetReport(
            fleet_id=self._fleet_id,
            winner_id=self._winner_id,
            winner_score=(
                self._records[self._winner_id].score
                if self._winner_id
                else None
            ),
            champion_dir=self._champion_dir,
            total_steps_trained=sum(
                record.steps_trained
                for record in self._records.values()
            ),
            graft_attempts=(
                self._counter_value("fleet.graft.attempts")
                - graft_attempts0
            ),
            graft_hits=(
                sum(
                    record.grafted_iterations
                    for record in self._records.values()
                )
                + self._champion_grafts
            ),
            compile_store_hits=0,
            trials={
                trial_id: record.to_json()
                for trial_id, record in self._records.items()
            },
            complete=True,
        )

    def _counter_value(self, name: str) -> int:
        return self._registry.counter(name).value

    def _live(self) -> List[TrialRecord]:
        return [
            record
            for record in self._records.values()
            if record.state == LIVE
        ]

    def _run_rung(self, rung: int) -> None:
        """Trains every live trial up to this rung's cumulative budget
        through the lease-based callable queue."""
        target = self._rungs[rung]
        self._respawn_failed(rung)
        runnable = [
            record for record in self._live() if record.rung < rung
        ]
        if not runnable:
            return
        _LOG.info(
            "Fleet %s rung %d: %d trial(s) -> %d iteration(s) "
            "(%d worker slot(s)).",
            self._fleet_id,
            rung,
            len(runnable),
            target,
            self._workers,
        )

        def make_runner(record: TrialRecord):
            def runner():
                self._run_trial(record, rung, target)

            return runner

        from adanet_tpu_torch.distributed.scheduler import drain_callables

        failures = drain_callables(
            [make_runner(record) for record in runnable],
            num_workers=min(self._workers, len(runnable)),
            devices=[self._device],
            kv=self._kv,
            labels=[record.spec.trial_id for record in runnable],
            on_error="isolate",
        )
        if failures:
            # Trial estimators rebound the default recorder to their own
            # model dirs; fleet-level forensics belong under the fleet.
            flightrec_lib.install_default(
                os.path.join(self._work_dir, flightrec_lib.DEFAULT_SUBDIR)
            )
        for record in runnable:
            exc = failures.get(record.spec.trial_id)
            if exc is None:
                continue
            record.state = FAILED
            record.error = "%s: %s" % (type(exc).__name__, exc)
            self._registry.counter("fleet.trials.failed").inc()
            spans_lib.tracer().instant(
                "fleet.trial_failed",
                trial_id=record.spec.trial_id,
                rung=rung,
                error=record.error,
            )
            flightrec_lib.dump_installed(
                "fleet_trial_failed",
                extra={
                    "trial_id": record.spec.trial_id,
                    "rung": rung,
                    "error": record.error,
                },
            )
            _LOG.error(
                "Fleet trial %s failed at rung %d: %s",
                record.spec.trial_id,
                rung,
                record.error,
            )

    def _respawn_failed(self, rung: int) -> None:
        """Failed trials with attempts left relaunch into a FRESH dir,
        grafting their dead incarnation's published progress (and any
        compatible sibling's) back from the store."""
        for record in self._records.values():
            if record.state != FAILED:
                continue
            if record.attempt + 1 >= self._max_trial_attempts:
                continue
            record.attempt += 1
            record.state = LIVE
            record.error = None
            record.rung = -1 if rung == 0 else rung - 1
            record.model_dir = self._trial_dir(
                record.spec.trial_id, record.attempt
            )
            record.launched = False
            spans_lib.tracer().instant(
                "fleet.respawn",
                trial_id=record.spec.trial_id,
                attempt=record.attempt,
            )
            _LOG.warning(
                "Fleet trial %s respawning (attempt %d) into %s.",
                record.spec.trial_id,
                record.attempt,
                record.model_dir,
            )

    def _donors(self) -> List[Tuple[TrialSpec, str]]:
        """Every potential donor dir: all incarnations of all trials,
        culled included — their published members outlive their
        capacity. (The champion dir is deliberately NOT a donor: it is
        itself a pure graft of the winner's refs, so it can never
        record more than the winner already donates.)"""
        donors: List[Tuple[TrialSpec, str]] = []
        for record in self._records.values():
            for attempt in range(record.attempt + 1):
                donors.append(
                    (
                        record.spec,
                        self._trial_dir(record.spec.trial_id, attempt),
                    )
                )
        return donors

    def _run_trial(
        self, record: TrialRecord, rung: int, target: int
    ) -> None:
        """One trial's rung work: graft what the store already holds,
        train the rest. Runs on a queue worker thread."""
        with spans_lib.tracer().span(
            "fleet.trial.run",
            correlation={"trial_id": record.spec.trial_id},
            rung=rung,
            target_iterations=target,
        ):
            started = self._clock()
            plan = None
            try:
                plan = transfer_lib.plan_graft(
                    record.spec,
                    self._donors(),
                    exclude_dir=record.model_dir,
                )
            except Exception as exc:
                # Graft unavailability costs compute, never correctness:
                # the trial trains every iteration itself.
                _LOG.warning(
                    "Graft planning for trial %s failed (%s: %s); "
                    "training without a graft.",
                    record.spec.trial_id,
                    type(exc).__name__,
                    exc,
                )
            if not record.launched:
                record.launched = True
                self._registry.counter("fleet.trials.launched").inc()
            pulls = [0]
            base_input_fn = self._input_fn

            def counting_input_fn():
                for batch in base_input_fn():
                    pulls[0] += 1
                    yield batch

            estimator = record.spec.build_estimator(
                record.model_dir,
                self._store,
                max_iterations=target,
                replay_config=plan.config if plan else None,
                device=self._device,
            )
            try:
                estimator.train(counting_input_fn)
            finally:
                record.steps_trained += pulls[0]
                record.train_secs += self._clock() - started
            record.iterations = estimator.latest_iteration_number()
            grafted = estimator._store_graft_count
            if grafted:
                record.grafted_iterations += grafted
                self._registry.counter("fleet.graft.hits").inc(grafted)
            record.rung = rung

    # ------------------------------------------------------------ promotion

    def _promote(self, rung: int) -> None:
        """Scores this rung's survivors and culls the tail.

        The `fleet.promote` fault site fires at entry: a SIGKILL here is
        the chaos gate's scenario — the rung's training is durable, the
        promotion decision is not, and a resumed controller must re-make
        it identically.
        """
        # Rebind crash forensics to the fleet before the seam fires.
        flightrec_lib.install_default(
            os.path.join(self._work_dir, flightrec_lib.DEFAULT_SUBDIR)
        )
        faults_lib.trip("fleet.promote")
        live = [
            record for record in self._live() if record.rung >= rung
        ]
        for record in live:
            try:
                record.score = self._score_trial(record)
            except Exception as exc:
                record.state = FAILED
                record.error = "scoring: %s: %s" % (
                    type(exc).__name__,
                    exc,
                )
                self._registry.counter("fleet.trials.failed").inc()
                _LOG.error(
                    "Scoring trial %s failed: %s",
                    record.spec.trial_id,
                    record.error,
                )
        scored = [
            record
            for record in live
            if record.state == LIVE and record.score is not None
        ]
        ranking = comparator_lib.rank(
            [record.score for record in scored]
        )
        order = {
            score.trial_id: position
            for position, score in enumerate(ranking)
        }
        scored.sort(key=lambda r: order[r.spec.trial_id])
        last_rung = rung == len(self._rungs) - 1
        survivors = (
            len(scored)
            if last_rung
            else max(
                1,
                math.ceil(len(scored) * self._survivor_fraction),
            )
        )
        for position, record in enumerate(scored):
            if position < survivors:
                self._registry.counter("fleet.trials.promoted").inc()
                continue
            record.state = CULLED
            self._registry.counter("fleet.trials.culled").inc()
            spans_lib.tracer().instant(
                "fleet.cull",
                trial_id=record.spec.trial_id,
                rung=rung,
                objective=(
                    record.score.objective if record.score else None
                ),
            )
            _LOG.info(
                "Fleet %s rung %d culled trial %s (objective %s); its "
                "capacity re-packs onto %d survivor(s).",
                self._fleet_id,
                rung,
                record.spec.trial_id,
                "%.6f" % record.score.objective
                if record.score
                else "n/a",
                survivors,
            )
        if last_rung and scored:
            self._winner_id = scored[0].spec.trial_id

    def _score_trial(self, record: TrialRecord) -> comparator_lib.Score:
        estimator = record.spec.build_estimator(
            record.model_dir,
            self._store,
            max_iterations=max(record.iterations, 1),
            device=self._device,
        )
        return self._comparator.score(estimator, record.spec.trial_id)

    def _pick_winner(self) -> None:
        """Fallback winner selection for degenerate resumes (state was
        persisted after the last promotion but before completion)."""
        scored = [
            record for record in self._live() if record.score is not None
        ]
        if not scored:
            scored = [
                record
                for record in self._records.values()
                if record.state in (LIVE, CULLED)
                and record.score is not None
            ]
        if scored:
            ranking = comparator_lib.rank(
                [record.score for record in scored]
            )
            self._winner_id = ranking[0].trial_id

    # ------------------------------------------------------------- champion

    def _run_champion(self) -> Optional[str]:
        """Replays the winner into `champion/` purely from store grafts:
        the fleet's canonical artifact, built with zero retraining."""
        winner = self._records[self._winner_id]
        champion_dir = os.path.join(self._work_dir, "champion")
        with spans_lib.tracer().span(
            "fleet.champion",
            correlation={"trial_id": winner.spec.trial_id},
            iterations=winner.iterations,
        ):
            try:
                plan = transfer_lib.plan_graft(
                    winner.spec,
                    self._donors(),
                    exclude_dir=champion_dir,
                )
            except Exception as exc:
                _LOG.warning(
                    "Champion graft planning failed (%s: %s); keeping "
                    "the winner's own dir as the fleet artifact.",
                    type(exc).__name__,
                    exc,
                )
                return winner.model_dir
            if plan is None:
                return winner.model_dir
            estimator = winner.spec.build_estimator(
                champion_dir,
                self._store,
                max_iterations=min(plan.iterations, winner.iterations)
                or winner.iterations,
                replay_config=plan.config,
                device=self._device,
            )
            try:
                estimator.train(self._input_fn)
            except Exception as exc:
                _LOG.error(
                    "Champion rebuild failed (%s: %s); keeping the "
                    "winner's own dir as the fleet artifact.",
                    type(exc).__name__,
                    exc,
                )
                return winner.model_dir
            if estimator._store_graft_count:
                self._champion_grafts += estimator._store_graft_count
                self._registry.counter("fleet.graft.hits").inc(
                    estimator._store_graft_count
                )
        return champion_dir


def load_status(work_dir: str) -> Optional[dict]:
    """The durable fleet state in `work_dir`, or None when absent or
    unreadable (`tools/fleetctl.py` distinguishes the two)."""
    try:
        return ckpt_lib.read_json(work_dir, STATE_FILENAME)
    except (OSError, ValueError):
        return None


__all__ = [
    "CULLED",
    "FAILED",
    "FleetController",
    "FleetReport",
    "LIVE",
    "STATE_FILENAME",
    "TrialRecord",
    "load_status",
]
