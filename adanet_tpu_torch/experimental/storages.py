"""Model storages for the experimental ModelFlow stack.

Analogue of reference storages
(reference: adanet/experimental/storages/storage.py and
in_memory_storage.py:26-59): a heap-ordered store of (score, model).
"""

from __future__ import annotations

import abc
import heapq
import itertools
import threading
from typing import Any, List, Sequence


class ModelContainer:
    """A (score, model, metrics) triple ordered by score
    (reference: storages/storage.py ModelContainer)."""

    _counter = itertools.count()

    def __init__(self, score: float, model: Any, metrics: Sequence[float]):
        self.score = float(score)
        self.model = model
        self.metrics = list(metrics)
        self._tiebreak = next(self._counter)

    def __lt__(self, other: "ModelContainer") -> bool:
        return (self.score, self._tiebreak) < (other.score, other._tiebreak)


class Storage(abc.ABC):
    """Abstract model store (reference: storages/storage.py)."""

    @abc.abstractmethod
    def save_model(self, model_container: ModelContainer):
        ...

    @abc.abstractmethod
    def get_models(self) -> List[Any]:
        ...

    @abc.abstractmethod
    def get_best_models(self, num_models: int = 1) -> List[Any]:
        ...


class InMemoryStorage(Storage):
    """Heap-ordered in-memory store (reference: in_memory_storage.py:26-59).

    Thread-safe: `ParallelScheduler` work units save concurrently.
    """

    def __init__(self):
        self._containers: List[ModelContainer] = []
        self._lock = threading.Lock()

    def save_model(self, model_container: ModelContainer):
        with self._lock:
            heapq.heappush(self._containers, model_container)

    def get_models(self) -> List[Any]:
        with self._lock:
            return [c.model for c in self._containers]

    def get_best_models(self, num_models: int = 1) -> List[Any]:
        with self._lock:
            return [
                c.model
                for c in heapq.nsmallest(num_models, self._containers)
            ]

    def get_model_metrics(self) -> List[List[float]]:
        with self._lock:
            return [c.metrics for c in self._containers]
