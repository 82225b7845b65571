"""A minimal trainable-model wrapper: the keras.Model role in ModelFlow.

Port of adanet_tpu/experimental/model.py. A `Model` is an `nn.Module`
whose `forward(features, training=False)` returns outputs (logits), a
loss `fn(outputs, labels) -> 0-d tensor`, an optimizer factory `params
-> torch.optim.Optimizer` (the optax transform's role), metric functions
of the same form as the loss, and `compile`/`fit`/`evaluate` semantics;
`trainable=False` freezes it (a submodel of an ensemble).

The device and the generator are explicit: `device` (default "cuda",
raising without CUDA; "cpu" on request) is where the module, its
batches and its evaluation live, and `seed` seeds a `torch.Generator`
that initialises the module on first use, through its own
`init_parameters(generator)` when it has one, else every submodule's
`reset_parameters()` under torch's CPU generator forked and seeded
from it (the module is on the CPU until then; the generator's state is
restored; one initialisation at a time,
under a lock, so that the workers of a `ParallelScheduler` draw each
model's numbers from its own seed). `load_state_dict` starts a model
from given numbers instead (`utils.convert.convert_model` carries a JAX
`Model`'s variables across). `evaluate` returns example-weighted means,
as the JAX version's and the core eval loops do: each batch's values
stay on the device and are read in one copy every `EVAL_FETCH_WINDOW`
batches.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Iterable, List, Optional

import torch

from adanet_tpu_torch._device import resolve_device
from adanet_tpu_torch.utils.batches import (
    EVAL_FETCH_WINDOW,
    WeightedMeanAccumulator,
    batch_example_count,
    to_device,
)


#: Serialises the initialisations that seed torch's global generator.
_GLOBAL_RNG_LOCK = threading.Lock()


def init_module(module: torch.nn.Module, seed: int) -> None:
    """Initialises `module`'s parameters from `seed`: its own
    `init_parameters(generator)` when it has one, else every submodule's
    `reset_parameters()` under torch's CPU generator, forked and seeded
    from `seed`, one initialisation at a time."""
    generator = torch.Generator().manual_seed(seed)
    own = getattr(module, "init_parameters", None)
    if callable(own):
        own(generator)
        return
    with _GLOBAL_RNG_LOCK, torch.random.fork_rng(devices=[]):
        torch.default_generator.manual_seed(int(torch.randint(0, 2**62, (), generator=generator)))
        for layer in module.modules():
            reset = getattr(layer, "reset_parameters", None)
            if callable(reset):
                reset()


class Model:
    """A trainable module with fit/evaluate.

    Args:
      module: `nn.Module`; `module(features, training=...)` returns outputs.
      loss_fn: `fn(outputs, labels) -> 0-d tensor`.
      optimizer: factory `params -> torch.optim.Optimizer` (set by
        `compile` if not given).
      metrics: dict name -> `fn(outputs, labels) -> 0-d tensor`.
      trainable: when False, `fit` is a no-op (frozen submodel).
      seed: seeds the module's initialisation.
      device: where the model runs ("cuda" by default; "cpu" on request).
    """

    def __init__(
        self,
        module,
        loss_fn: Optional[Callable] = None,
        optimizer=None,
        metrics: Optional[Dict[str, Callable]] = None,
        trainable: bool = True,
        seed: int = 0,
        device=None,
    ):
        self.module = module
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.metrics = dict(metrics or {})
        self.trainable = trainable
        self.device = resolve_device(device)
        self._seed = seed
        self._initialized = False
        self._optimizer_state = None

    def compile(self, optimizer, loss_fn, metrics=None):
        """Keras-style compile (reference work units call model.compile)."""
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        if metrics is not None:
            self.metrics = dict(metrics)
        return self

    # ------------------------------------------------------------------ core

    def _ensure_initialized(self, features):
        del features  # torch modules know their shapes when built
        if not self._initialized:
            init_module(self.module, self._seed)
            self.module.to(self.device)
            self._initialized = True
        if self._optimizer_state is None and self.optimizer is not None:
            self._optimizer_state = self.optimizer(list(self.module.parameters()))

    def load_state_dict(self, state_dict) -> "Model":
        """Starts the model from `state_dict` instead of its seeded init."""
        self.module.load_state_dict(state_dict)
        self.module.to(self.device)
        self._initialized = True
        return self

    def _forward(self, features, training: bool):
        self.module.train(training)
        return self.module(features, training=training)

    def __call__(self, features, training: bool = False):
        self._ensure_initialized(features)
        return self._forward(to_device(features, self.device), training)

    def fit(self, dataset: Iterable, epochs: int = 1) -> "Model":
        """Trains over the dataset; `dataset` yields (features, labels),
        or is a zero-arg callable returning such an iterable (required to
        be a callable or re-iterable when epochs > 1 — a one-shot iterator
        is materialized so later epochs aren't silently empty)."""
        if not self.trainable:
            return self
        if self.loss_fn is None or self.optimizer is None:
            raise ValueError("Model must be compiled before fit().")
        if callable(dataset):
            get_epoch = dataset
        elif epochs > 1 and iter(dataset) is dataset:
            batches = list(dataset)
            get_epoch = lambda: batches
        else:
            get_epoch = lambda: dataset

        for _ in range(epochs):
            for features, labels in get_epoch():
                self._ensure_initialized(features)
                features, labels = to_device((features, labels), self.device)
                loss = self.loss_fn(self._forward(features, training=True), labels)
                optimizer = self._optimizer_state
                optimizer.zero_grad(set_to_none=True)
                loss.backward()
                optimizer.step()
        return self

    def evaluate(self, dataset: Iterable) -> List[float]:
        """Returns [loss, metric...] means, keras-style."""
        if self.loss_fn is None:
            raise ValueError("Model must be compiled before evaluate().")

        # Example-weighted means, matching the core eval loops (a ragged
        # final batch must not be over-weighted). Each batch's values stay
        # on the device and are read in one copy a window of batches.
        acc = WeightedMeanAccumulator()
        staged = []

        def drain():
            if staged:
                values = torch.stack([v for v, _ in staged]).tolist()
                for row, (_, count) in zip(values, staged):
                    acc.add({str(i): v for i, v in enumerate(row)}, count)
            staged.clear()

        with torch.no_grad():
            for features, labels in dataset:
                count = batch_example_count((features, labels))
                out = self(features, training=False)
                labels = to_device(labels, self.device)
                values = [self.loss_fn(out, labels)]
                for name in sorted(self.metrics):
                    values.append(self.metrics[name](out, labels))
                staged.append((torch.stack([torch.as_tensor(v, dtype=torch.float32, device=self.device)
                                            .reshape(()) for v in values]), count))
                if len(staged) >= EVAL_FETCH_WINDOW:
                    drain()
        drain()
        if acc.batches == 0:
            raise ValueError("evaluate() got an empty dataset.")
        means = acc.means()
        return [means[str(i)] for i in range(len(means))]
