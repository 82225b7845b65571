"""Phases, work units, controllers, and schedulers for ModelFlow.

Port of adanet_tpu/experimental/phases.py (after the reference's
experimental pipeline: adanet/experimental/phases/*, work_units/*,
controllers/*, schedulers/*): a linear workflow of Phases, each yielding
WorkUnits that a Scheduler executes; phases chain by reading the
previous phase's datasets and models. The same code but for the tensor
parts: `MeanEnsemble` averages its submodels' outputs with torch, and
`WeightedEnsemble`'s combiner is `einsum("...k,k->...", stacked,
mixture) + bias` over the submodels' outputs held fixed (plain torch, as
the JAX combiner is plain `jnp`; not K1, whose layout and bias differ);
`ParallelScheduler` drains through the port's
`distributed.scheduler.drain_callables`, one worker per device of its
pool (by default every visible card), each pinned to its device.
"""

from __future__ import annotations

import abc
import random
import threading
from typing import (
    Any,
    Callable,
    Dict,
    Iterable,
    Iterator,
    List,
    Optional,
    Sequence,
    Tuple,
)

import torch

from adanet_tpu_torch.experimental.model import Model
from adanet_tpu_torch.experimental.storages import (
    InMemoryStorage,
    ModelContainer,
    Storage,
)

# ------------------------------------------------------------------ work units


class WorkUnit(abc.ABC):
    """A schedulable unit of work (reference: work_units/work_unit.py)."""

    @abc.abstractmethod
    def execute(self) -> None:
        ...


class PhaseBarrier(WorkUnit):
    """Marks a phase boundary in the work-unit stream.

    Phases read their predecessor's storage lazily when their generator is
    first pulled, so a concurrent scheduler must finish every in-flight
    unit before crossing a boundary. Sequential schedulers execute it as a
    no-op.
    """

    def execute(self) -> None:
        return None


class TrainerWorkUnit(WorkUnit):
    """fit -> evaluate -> store (reference: keras_trainer_work_unit.py:27-55)."""

    def __init__(
        self,
        model: Model,
        train_dataset: Callable[[], Iterable],
        eval_dataset: Callable[[], Iterable],
        storage: Storage,
        epochs: int = 1,
        on_result: Optional[Callable[[List[float]], None]] = None,
    ):
        self._model = model
        self._train_dataset = train_dataset
        self._eval_dataset = eval_dataset
        self._storage = storage
        self._epochs = epochs
        # Result hook for adaptive consumers (the TunerPhase feedback
        # loop); called after the evaluation completes.
        self._on_result = on_result

    def execute(self) -> None:
        if self._model.trainable:
            self._model.fit(self._train_dataset(), epochs=self._epochs)
        results = self._model.evaluate(self._eval_dataset())
        self._storage.save_model(
            ModelContainer(results[0], self._model, results)
        )
        if self._on_result is not None:
            self._on_result(list(results))


# --------------------------------------------------------------------- phases


class Phase(abc.ABC):
    """A stage in a linear workflow (reference: phases/phase.py:26-37)."""

    def __init__(self, storage: Optional[Storage] = None):
        self._storage = storage or InMemoryStorage()

    @abc.abstractmethod
    def work_units(
        self, previous_phase: Optional["Phase"]
    ) -> Iterator[WorkUnit]:
        ...


class DatasetProvider(Phase, abc.ABC):
    """A phase that produces datasets (reference: phase.py:39-52)."""

    @abc.abstractmethod
    def get_train_dataset(self) -> Callable[[], Iterable]:
        ...

    @abc.abstractmethod
    def get_eval_dataset(self) -> Callable[[], Iterable]:
        ...


class ModelProvider(Phase, abc.ABC):
    """A phase that produces models (reference: phase.py:64-75)."""

    @abc.abstractmethod
    def get_models(self) -> Iterable[Model]:
        ...

    @abc.abstractmethod
    def get_best_models(self, num_models: int = 1) -> Iterable[Model]:
        ...


class InputPhase(DatasetProvider):
    """Supplies train/eval datasets (reference: phases/input_phase.py)."""

    def __init__(self, train_dataset, eval_dataset):
        super().__init__()
        self._train = train_dataset
        self._eval = eval_dataset

    def get_train_dataset(self):
        return self._train

    def get_eval_dataset(self):
        return self._eval

    def work_units(self, previous_phase):
        return iter(())


def _datasets_from(previous_phase: Optional[Phase]):
    if not isinstance(previous_phase, DatasetProvider):
        raise ValueError(
            "This phase must follow a DatasetProvider, got %r"
            % (previous_phase,)
        )
    return (
        previous_phase.get_train_dataset(),
        previous_phase.get_eval_dataset(),
    )


class TrainerPhase(DatasetProvider, ModelProvider):
    """Trains a fixed list of models
    (reference: phases/keras_trainer_phase.py:28-71)."""

    def __init__(
        self,
        models: Sequence[Model],
        epochs: int = 1,
        storage: Optional[Storage] = None,
    ):
        Phase.__init__(self, storage)
        self._models = list(models)
        self._epochs = epochs
        self._train = None
        self._eval = None

    def work_units(self, previous_phase):
        self._train, self._eval = _datasets_from(previous_phase)
        for model in self._models:
            yield TrainerWorkUnit(
                model, self._train, self._eval, self._storage, self._epochs
            )

    def get_train_dataset(self):
        return self._train

    def get_eval_dataset(self):
        return self._eval

    def get_models(self):
        return self._storage.get_models()

    def get_best_models(self, num_models: int = 1):
        return self._storage.get_best_models(num_models)


class Tuner(abc.ABC):
    """Trial-by-trial hyperparameter oracle.

    The analogue of the KerasTuner Oracle the reference's tuner phase
    wraps (reference: phases/keras_tuner_phase.py:29-71): `create_trial`
    proposes the next hyperparameters (None = search done) and
    `report_trial` feeds the trial's score back, so later proposals can
    depend on earlier results — adaptive search, not a pre-sampled list.
    """

    @abc.abstractmethod
    def create_trial(self) -> Optional[Dict[str, Any]]:
        """Next trial's hyperparameters, or None when the search is over."""

    @abc.abstractmethod
    def report_trial(self, hparams: Dict[str, Any], score: float) -> None:
        """Feeds back a finished trial's score (lower is better)."""


class RandomSearchTuner(Tuner):
    """Uniform random search over a discrete space.

    `space` maps each hyperparameter name to a sequence of choices (or a
    zero-arg callable producing a value).
    """

    def __init__(self, space: Dict[str, Any], max_trials: int = 4, seed: int = 0):
        if not space:
            raise ValueError("space must be non-empty")
        self._space = dict(space)
        self._max_trials = int(max_trials)
        self._rng = random.Random(seed)
        self._trials: List[Tuple[Dict[str, Any], Optional[float]]] = []
        # ParallelScheduler work units report concurrently; duplicate
        # hparams must claim distinct trial slots. Reentrant: subclass
        # create_trial consults best_trial() under the same lock.
        self._lock = threading.RLock()

    @property
    def trials(self) -> List[Tuple[Dict[str, Any], Optional[float]]]:
        """(hparams, score) per trial, in creation order (copies: the
        tuner's history must not alias caller-visible dicts)."""
        with self._lock:
            return [(dict(h), s) for h, s in self._trials]

    def _sample(self) -> Dict[str, Any]:
        out = {}
        for name, choices in self._space.items():
            out[name] = (
                choices() if callable(choices) else self._rng.choice(choices)
            )
        return out

    def create_trial(self) -> Optional[Dict[str, Any]]:
        with self._lock:
            if len(self._trials) >= self._max_trials:
                return None
            hparams = self._sample()
            # Store a private copy: user code (build_model) may mutate the
            # returned dict, and the trial history is the search state.
            self._trials.append((dict(hparams), None))
            return hparams

    def report_trial(self, hparams: Dict[str, Any], score: float) -> None:
        with self._lock:
            # Earliest unscored slot with these hparams: duplicate trials
            # each claim their own slot even under concurrent reports.
            for i, (trial_hparams, trial_score) in enumerate(self._trials):
                if trial_hparams == hparams and trial_score is None:
                    # Copy: a caller mutating hparams after reporting must
                    # not corrupt the scored history (create_trial/trials/
                    # best_trial already copy).
                    self._trials[i] = (dict(hparams), float(score))
                    return

    def best_trial(self) -> Optional[Tuple[Dict[str, Any], float]]:
        with self._lock:
            scored = [t for t in self._trials if t[1] is not None]
        if not scored:
            return None
        hparams, score = min(scored, key=lambda t: t[1])
        return dict(hparams), score


class GreedyMutationTuner(RandomSearchTuner):
    """Adaptive hill climbing: random warmup, then mutate the best trial.

    After `warmup_trials` uniform samples, each new trial copies the
    best-scoring hyperparameters so far and re-samples ONE dimension —
    proposals genuinely depend on reported results (the adaptivity the
    reference gets from KerasTuner oracles)."""

    def __init__(
        self,
        space: Dict[str, Any],
        max_trials: int = 8,
        warmup_trials: int = 2,
        seed: int = 0,
    ):
        super().__init__(space, max_trials=max_trials, seed=seed)
        self._warmup = int(warmup_trials)

    def create_trial(self) -> Optional[Dict[str, Any]]:
        with self._lock:
            if len(self._trials) >= self._max_trials:
                return None
            best = self.best_trial()
            if len(self._trials) < self._warmup or best is None:
                hparams = self._sample()
            else:
                hparams = dict(best[0])
                name = self._rng.choice(sorted(self._space))
                choices = self._space[name]
                if callable(choices):
                    hparams[name] = choices()
                else:
                    # A "mutation" that re-samples the incumbent value is
                    # a wasted train/eval cycle; exclude it when other
                    # choices exist.
                    alternatives = [
                        c for c in choices if c != hparams[name]
                    ]
                    hparams[name] = self._rng.choice(
                        alternatives or list(choices)
                    )
            self._trials.append((dict(hparams), None))
            return hparams


class TunerPhase(TrainerPhase):
    """Adaptive hyperparameter search over a model-builder function.

    The analogue of the reference's KerasTuner phase
    (reference: phases/keras_tuner_phase.py:29-71): the `tuner` proposes
    hyperparameters trial by trial; each trial's model is built LAZILY,
    trained/evaluated as a work unit, and its score reported back before
    the next trial is proposed — so adaptive tuners steer the search and
    memory holds one un-trained model at a time, not the whole trial
    list.

    Adaptivity requires a sequential scheduler (`InProcessScheduler`);
    under `ParallelScheduler` trials overlap, so reports arrive late and
    an adaptive tuner degrades toward its warmup behavior (random
    search is unaffected).
    """

    def __init__(
        self,
        build_model: Callable[[Dict[str, Any]], Model],
        tuner: Tuner,
        epochs: int = 1,
        storage: Optional[Storage] = None,
    ):
        super().__init__([], epochs=epochs, storage=storage)
        self._build_model = build_model
        self._tuner = tuner

    def work_units(self, previous_phase):
        self._train, self._eval = _datasets_from(previous_phase)
        while True:
            hparams = self._tuner.create_trial()
            if hparams is None:
                return
            # Snapshot before user code runs: build_model may mutate its
            # argument, and the report must match the proposed trial.
            trial_key = dict(hparams)
            model = self._build_model(hparams)
            yield TrainerWorkUnit(
                model,
                self._train,
                self._eval,
                self._storage,
                self._epochs,
                on_result=lambda results, hp=trial_key: (
                    self._tuner.report_trial(hp, results[0])
                ),
            )


# ------------------------------------------------ ensemble phase + strategies


class EnsembleStrategy(abc.ABC):
    """Groups candidates into ensembles (reference: autoensemble_phase.py:33-41)."""

    @abc.abstractmethod
    def __call__(
        self, candidates: List[Model]
    ) -> Iterable[List[Model]]:
        ...


class GrowStrategy(EnsembleStrategy):
    """One candidate at a time (reference: autoensemble_phase.py:84-91)."""

    def __call__(self, candidates):
        return [[candidate] for candidate in candidates]


class AllStrategy(EnsembleStrategy):
    """All candidates together (reference: autoensemble_phase.py:93-99)."""

    def __call__(self, candidates):
        return [list(candidates)]


class RandomKStrategy(EnsembleStrategy):
    """k random candidates with replacement
    (reference: autoensemble_phase.py:101-107)."""

    def __init__(self, k: int, seed: Optional[int] = None):
        self._k = k
        self._seed = seed

    def __call__(self, candidates):
        rng = random.Random(self._seed)
        return [[rng.choice(candidates) for _ in range(self._k)]]


class MeanEnsemble(Model):
    """Frozen-submodel mean-of-outputs ensemble
    (reference: keras/ensemble_model.py:26-60). It lives on its first
    submodel's device; `evaluate` is `Model.evaluate` over its outputs
    (example-weighted means)."""

    def __init__(self, submodels: Sequence[Model], loss_fn, metrics=None):
        self._submodels = list(submodels)
        super().__init__(
            module=None, loss_fn=loss_fn, metrics=metrics, trainable=False, device=self._submodels[0].device
        )

    def _ensure_initialized(self, features):
        for submodel in self._submodels:
            submodel._ensure_initialized(features)

    def __call__(self, features, training: bool = False):
        outs = [m(features, training=False).to(self.device) for m in self._submodels]
        return torch.mean(torch.stack(outs, dim=0), dim=0)


class MeanEnsembler:
    """Combines submodels into a `MeanEnsemble`
    (reference: autoensemble_phase.py:54-81)."""

    def __init__(self, loss_fn, metrics=None):
        self._loss_fn = loss_fn
        self._metrics = metrics

    def __call__(self, submodels: List[Model]) -> MeanEnsemble:
        return MeanEnsemble(submodels, self._loss_fn, self._metrics)


class _WeightedCombinerModule(torch.nn.Module):
    """The trainable combiner: a dense over the stacked submodel outputs,
    the frozen submodel forwards baked in (not registered as submodules,
    so the combiner's parameters are its own two).

    Initialized at 1/k (exactly the mean ensemble), then the combiner
    weights train on the ensemble loss while the submodel outputs are
    held fixed (computed without gradients, JAX's `stop_gradient`) — the
    reference's trainable Dense over stacked outputs
    (reference: adanet/experimental/keras/ensemble_model.py:60-87).
    """

    def __init__(self, submodels: Sequence[Model]):
        super().__init__()
        self._submodels = tuple(submodels)
        k = len(self._submodels)
        self.mixture = torch.nn.Parameter(torch.full((k,), 1.0 / k))
        self.bias = torch.nn.Parameter(torch.zeros(()))

    def init_parameters(self, generator: torch.Generator) -> None:
        del generator  # a fixed start: the mean ensemble
        with torch.no_grad():
            self.mixture.fill_(1.0 / len(self._submodels))
            self.bias.zero_()

    def _stacked(self, features):
        # Model.__call__ handles plain and composite (MeanEnsemble)
        # submodels, each on its own device.
        with torch.no_grad():
            outs = [m(features, training=False).to(self.mixture.device) for m in self._submodels]
        return torch.stack(outs, dim=-1)

    def forward(self, features, training: bool = False):
        del training
        stacked = self._stacked(features)  # [batch, out, k]
        return torch.einsum("...k,k->...", stacked, self.mixture) + self.bias


class WeightedEnsemble(Model):
    """Trainable weighted combination of frozen submodels
    (reference: adanet/experimental/keras/ensemble_model.py:60-87), on
    its first submodel's device."""

    def __init__(
        self,
        submodels: Sequence[Model],
        loss_fn,
        optimizer,
        metrics=None,
        seed: int = 0,
    ):
        super().__init__(
            module=_WeightedCombinerModule(submodels),
            loss_fn=loss_fn,
            optimizer=optimizer,
            metrics=metrics,
            trainable=True,
            seed=seed,
            device=submodels[0].device,
        )
        self._submodels = list(submodels)

    def _ensure_initialized(self, features):
        # Submodels materialize their parameters before the combiner's
        # first step.
        for submodel in self._submodels:
            submodel._ensure_initialized(features)
        super()._ensure_initialized(features)

    @property
    def mixture_weights(self):
        return self.module.mixture


class WeightedEnsembler:
    """Combines submodels into a trainable `WeightedEnsemble`."""

    def __init__(self, loss_fn, optimizer, metrics=None):
        self._loss_fn = loss_fn
        self._optimizer = optimizer
        self._metrics = metrics

    def __call__(self, submodels: List[Model]) -> WeightedEnsemble:
        return WeightedEnsemble(
            submodels, self._loss_fn, self._optimizer, self._metrics
        )


class AutoEnsemblePhase(DatasetProvider, ModelProvider):
    """Ensembles the previous phase's best models
    (reference: phases/autoensemble_phase.py:110-180)."""

    def __init__(
        self,
        ensemblers: Sequence[Any],
        ensemble_strategies: Sequence[EnsembleStrategy],
        num_candidates: int = 3,
        storage: Optional[Storage] = None,
    ):
        Phase.__init__(self, storage)
        self._ensemblers = list(ensemblers)
        self._strategies = list(ensemble_strategies)
        self._num_candidates = num_candidates
        self._train = None
        self._eval = None

    def work_units(self, previous_phase):
        if not isinstance(previous_phase, ModelProvider):
            raise ValueError("AutoEnsemblePhase must follow a ModelProvider.")
        self._train, self._eval = _datasets_from(previous_phase)
        candidates = list(
            previous_phase.get_best_models(self._num_candidates)
        )
        for strategy in self._strategies:
            for group in strategy(candidates):
                for ensembler in self._ensemblers:
                    yield TrainerWorkUnit(
                        ensembler(group),
                        self._train,
                        self._eval,
                        self._storage,
                    )

    def get_train_dataset(self):
        return self._train

    def get_eval_dataset(self):
        return self._eval

    def get_models(self):
        return self._storage.get_models()

    def get_best_models(self, num_models: int = 1):
        return self._storage.get_best_models(num_models)


class RepeatPhase(DatasetProvider, ModelProvider):
    """Repeats a phase-factory pipeline n times
    (reference: phases/repeat_phase.py)."""

    def __init__(
        self,
        phase_factory: Sequence[Callable[[], Phase]],
        repetitions: int,
        storage: Optional[Storage] = None,
    ):
        Phase.__init__(self, storage)
        self._phase_factory = list(phase_factory)
        self._repetitions = repetitions
        self._final_phase: Optional[Phase] = None

    def work_units(self, previous_phase):
        prev = previous_phase
        for _ in range(self._repetitions):
            for factory in self._phase_factory:
                phase = factory()
                for work_unit in phase.work_units(prev):
                    yield work_unit
                yield PhaseBarrier()  # see SequentialController.work_units
                prev = phase
        self._final_phase = prev

    def get_train_dataset(self):
        return self._final_phase.get_train_dataset()

    def get_eval_dataset(self):
        return self._final_phase.get_eval_dataset()

    def get_models(self):
        return self._final_phase.get_models()

    def get_best_models(self, num_models: int = 1):
        return self._final_phase.get_best_models(num_models)


# --------------------------------------------------- controllers + schedulers


class Controller(abc.ABC):
    """Yields work units from phases (reference: controllers/controller.py)."""

    @abc.abstractmethod
    def work_units(self) -> Iterator[WorkUnit]:
        ...

    @abc.abstractmethod
    def get_best_models(self, num_models: int = 1) -> Iterable[Model]:
        ...


class SequentialController(Controller):
    """Executes phases in a user-defined order
    (reference: controllers/sequential_controller.py:26-50)."""

    def __init__(self, phases: Sequence[Phase]):
        if not phases:
            raise ValueError("phases must be non-empty.")
        self._phases = list(phases)

    def work_units(self) -> Iterator[WorkUnit]:
        previous = None
        for phase in self._phases:
            for work_unit in phase.work_units(previous):
                yield work_unit
            # Later phases read this phase's storage when their generator
            # is pulled; the barrier keeps concurrent schedulers correct.
            yield PhaseBarrier()
            previous = phase
        self._final_phase = previous

    def get_best_models(self, num_models: int = 1):
        return self._final_phase.get_best_models(num_models)


class Scheduler(abc.ABC):
    """Executes work units (reference: schedulers/scheduler.py)."""

    @abc.abstractmethod
    def schedule(self, work_units: Iterator[WorkUnit]) -> None:
        ...


class InProcessScheduler(Scheduler):
    """Runs work units sequentially in-process
    (reference: schedulers/in_process_scheduler.py:27-38)."""

    def schedule(self, work_units: Iterator[WorkUnit]) -> None:
        for work_unit in work_units:
            work_unit.execute()


class ParallelScheduler(Scheduler):
    """Runs a phase's work units concurrently, one device each.

    A thin shim over the port's lease-based work queue
    (`adanet_tpu_torch.distributed.scheduler.drain_callables`): units are
    claimed in published order under TTL leases renewed by heartbeat,
    each executing on a worker thread pinned to one device of the pool
    (`devices`, by default every visible card; raises without CUDA
    unless CPU devices are named), so independent model fits overlap.
    `num_workers` (default one a device) may exceed the pool: workers
    share devices round robin. `PhaseBarrier`s become queue barriers —
    all in-flight units drain before later phases' units publish,
    preserving the phase-chaining contract (later phases read earlier
    phases' storages). Exceptions surface to the caller after the
    drain.
    """

    def __init__(self, num_workers: Optional[int] = None, devices=None):
        from adanet_tpu_torch.distributed.scheduler import default_devices

        self._devices = list(devices) if devices is not None else default_devices()
        self._num_workers = num_workers

    def schedule(self, work_units: Iterator[WorkUnit]) -> None:
        from adanet_tpu_torch.distributed.scheduler import drain_callables

        num_workers = self._num_workers or len(self._devices)

        def stream():
            for work_unit in work_units:
                # None is drain_callables' barrier sentinel.
                yield None if isinstance(work_unit, PhaseBarrier) else (
                    work_unit.execute
                )

        drain_callables(stream(), num_workers, devices=self._devices)


class ModelSearch:
    """Top-level ModelFlow entry point
    (reference: keras/model_search.py:29-50)."""

    def __init__(
        self,
        controller: Controller,
        scheduler: Optional[Scheduler] = None,
    ):
        self._controller = controller
        self._scheduler = scheduler or InProcessScheduler()

    def run(self) -> None:
        self._scheduler.schedule(self._controller.work_units())

    def get_best_models(self, num_models: int = 1) -> Iterable[Model]:
        return self._controller.get_best_models(num_models)
