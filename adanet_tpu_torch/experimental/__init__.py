"""Experimental "ModelFlow" API: Phases -> WorkUnits -> Scheduler.

Port of adanet_tpu/experimental, with the same public names (after the
reference `adanet.experimental` package: adanet/experimental/__init__.py):
a second, greenfield pipeline API over plain trainable models
(`nn.Module`s), independent of the core AdaNet engine.
"""

from adanet_tpu_torch.experimental.model import Model
from adanet_tpu_torch.experimental.phases import (
    AllStrategy,
    AutoEnsemblePhase,
    Controller,
    DatasetProvider,
    EnsembleStrategy,
    GrowStrategy,
    InProcessScheduler,
    InputPhase,
    MeanEnsemble,
    MeanEnsembler,
    ModelProvider,
    ModelSearch,
    ParallelScheduler,
    Phase,
    PhaseBarrier,
    RandomKStrategy,
    RepeatPhase,
    Scheduler,
    SequentialController,
    TrainerPhase,
    TrainerWorkUnit,
    GreedyMutationTuner,
    RandomSearchTuner,
    Tuner,
    TunerPhase,
    WeightedEnsemble,
    WeightedEnsembler,
    WorkUnit,
)
from adanet_tpu_torch.experimental.storages import (
    InMemoryStorage,
    ModelContainer,
    Storage,
)

__all__ = [
    "AllStrategy",
    "AutoEnsemblePhase",
    "Controller",
    "DatasetProvider",
    "EnsembleStrategy",
    "GrowStrategy",
    "InMemoryStorage",
    "InProcessScheduler",
    "InputPhase",
    "MeanEnsemble",
    "MeanEnsembler",
    "Model",
    "ModelContainer",
    "ModelProvider",
    "ModelSearch",
    "ParallelScheduler",
    "Phase",
    "PhaseBarrier",
    "RandomKStrategy",
    "RepeatPhase",
    "Scheduler",
    "SequentialController",
    "Storage",
    "TrainerPhase",
    "TrainerWorkUnit",
    "GreedyMutationTuner",
    "RandomSearchTuner",
    "Tuner",
    "TunerPhase",
    "WeightedEnsemble",
    "WeightedEnsembler",
    "WorkUnit",
]
