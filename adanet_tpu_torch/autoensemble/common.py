"""Adapters that turn plain user models into AdaNet candidates.

Port of adanet_tpu/autoensemble/common.py. A candidate is any
`nn.Module` whose `forward(features, training=False)` returns logits (a
tensor or a dict of them) or a `Subnetwork`, paired with an optimizer
factory; the wrapper adapts it into a `Builder` producing a `Subnetwork`
with complexity 0 (reference common.py:188).

Torch modules carry their parameters where Flax modules do not, so
`build_subnetwork` returns a deep copy of the user's module: no two
candidates, and no two iterations, share parameters. The copy has no
`init_parameters(generator)` of its own as a rule, so the wrapper's
re-initialises it from the engine's generator (through the module's own
`init_parameters` when it has one): it forks torch's global random state,
seeds it from the generator and calls every submodule's
`reset_parameters()`, so a search depends on the Estimator's seed and
leaves torch's global state as it was. The wrapper sets the inner
module's training mode to the call's `training` (batch norm and
`nn.Dropout` read it), and passes the engine's dropout `generator` on
when the inner forward takes one.
"""

from __future__ import annotations

import copy
import dataclasses
import inspect
from typing import Any, Callable, Dict, List, Optional

import torch
from torch import nn

from adanet_tpu_torch.subnetwork.generator import Builder, Generator, Subnetwork


@dataclasses.dataclass(frozen=True)
class AutoEnsembleSubestimator:
    """A candidate model with optional dedicated training data.

    Attributes:
      module: an `nn.Module`; `module(features, training=...)` returns
        logits (a tensor, or a dict of head name to tensor) or a
        `Subnetwork`.
      optimizer: a factory `params -> torch.optim.Optimizer` training this
        candidate (default SGD at 0.01; ignored when `prediction_only`).
      train_input_fn: optional zero-arg callable yielding (features,
        labels) batches used ONLY by this candidate: per-candidate data
        is how bagging works (reference: common.py:76-88).
      prediction_only: freeze the candidate; only use it for inference
        (reference: common.py:89-92). Its training forward still runs
        (batch-norm statistics move, as under the JAX package's
        `set_to_zero`), its parameters never do.
      logits_fn: optional fn mapping the module's output to logits.
      last_layer_fn: optional fn mapping the module's output to the last
        hidden layer.
      initial_variables: optional `state_dict` of `module` loaded over
        its random init: how PRETRAINED modules enter the ensemble.
        Combine with `prediction_only=True` for frozen transfer learning,
        or leave trainable for fine-tuning.
    """

    module: Any
    optimizer: Optional[Callable] = None
    train_input_fn: Optional[Callable] = None
    prediction_only: bool = False
    logits_fn: Optional[Callable] = None
    last_layer_fn: Optional[Callable] = None
    initial_variables: Optional[Any] = None


class _ZeroUpdate(torch.optim.Optimizer):
    """`optax.set_to_zero()`: an optimizer whose step changes nothing."""

    def __init__(self, params):
        super().__init__(params, {})

    def step(self, closure=None):
        return None


class _AutoSubnetwork(nn.Module):
    """Adapts a plain-logits module into a `Subnetwork` producer."""

    def __init__(self, subestimator: AutoEnsembleSubestimator):
        super().__init__()
        self.inner = copy.deepcopy(subestimator.module)
        self._logits_fn = subestimator.logits_fn
        self._last_layer_fn = subestimator.last_layer_fn
        self._inner_takes_generator = "generator" in inspect.signature(self.inner.forward).parameters

    def init_parameters(self, generator: torch.Generator) -> None:
        """The inner module's own `init_parameters(generator)` when it has
        one; else every submodule's `reset_parameters()`, drawing from
        torch's global generator seeded from `generator`, the global state
        restored afterwards."""
        own = getattr(self.inner, "init_parameters", None)
        if callable(own):
            own(generator)
            return
        seed = int(torch.randint(0, 2**62, (), generator=generator))
        with torch.random.fork_rng():
            torch.manual_seed(seed)
            for module in self.inner.modules():
                reset = getattr(module, "reset_parameters", None)
                if callable(reset):
                    reset()

    def forward(self, features, training: bool = False, generator: Optional[torch.Generator] = None):
        if self.inner.training != training:
            self.inner.train(training)
        kwargs = {"generator": generator} if self._inner_takes_generator and generator is not None else {}
        out = self.inner(features, training=training, **kwargs)
        if isinstance(out, Subnetwork):
            return out
        logits = self._logits_fn(out) if self._logits_fn is not None else out
        last_layer = self._last_layer_fn(out) if self._last_layer_fn is not None else logits
        # Complexity hardcoded to 0, matching reference common.py:188.
        return Subnetwork(last_layer=last_layer, logits=logits, complexity=0.0)


class _BuilderFromSubestimator(Builder):
    """Builds the candidate's subnetwork from a wrapped module.

    Analogue of reference `_BuilderFromSubestimator`
    (reference: adanet/autoensemble/common.py:96-198).
    """

    def __init__(self, name: str, subestimator: AutoEnsembleSubestimator):
        self._name = name
        self._subestimator = subestimator

    @property
    def name(self) -> str:
        return self._name

    @property
    def train_input_fn(self):
        return self._subestimator.train_input_fn

    @property
    def prediction_only(self) -> bool:
        return self._subestimator.prediction_only

    @property
    def initial_variables(self):
        """The pretrained `state_dict` re-keyed under the wrapper's
        `inner` submodule (how it appears in the built subnetwork's
        `state_dict`); loaded by `Iteration.init_state`."""
        user = self._subestimator.initial_variables
        if user is None:
            return None
        return {"inner.%s" % key: value for key, value in user.items()}

    def build_subnetwork(self, logits_dimension, previous_ensemble=None, *, input_shape=None):
        del logits_dimension, input_shape  # the user module owns its shapes
        return _AutoSubnetwork(self._subestimator)

    def build_train_optimizer(self, previous_ensemble=None):
        if self._subestimator.prediction_only:
            # Zero-update optimizer: the candidate participates in
            # ensembles but its weights never move.
            return lambda named: _ZeroUpdate([p for _, p in named])
        factory = self._subestimator.optimizer or (lambda params: torch.optim.SGD(params, lr=0.01))
        return lambda named: factory([p for _, p in named])


def _normalize_pool(candidate_pool, iteration_number: int) -> Dict[str, AutoEnsembleSubestimator]:
    """dict/list/callable pool -> name->Subestimator dict.

    Reference semantics: adanet/autoensemble/common.py:201-216 (dict keys
    become names, sorted; list entries `candidate_<i>`; a callable
    receives `iteration_number`).
    """
    if callable(candidate_pool) and not isinstance(candidate_pool, dict):
        candidate_pool = candidate_pool(iteration_number=iteration_number)
    normalized: Dict[str, AutoEnsembleSubestimator] = {}
    if isinstance(candidate_pool, dict):
        items = sorted(candidate_pool.items())
    else:
        items = [("candidate_%d" % i, c) for i, c in enumerate(candidate_pool)]
    for name, cand in items:
        if not isinstance(cand, AutoEnsembleSubestimator):
            cand = AutoEnsembleSubestimator(module=cand)
        normalized[name] = cand
    return normalized


class _GeneratorFromCandidatePool(Generator):
    """Regenerates the candidate pool's builders each iteration.

    Analogue of reference `_GeneratorFromCandidatePool`
    (reference: adanet/autoensemble/common.py:218-268).
    """

    def __init__(self, candidate_pool):
        self._candidate_pool = candidate_pool

    def generate_candidates(
        self,
        previous_ensemble,
        iteration_number,
        previous_ensemble_reports,
        all_reports,
        config=None,
    ) -> List[Builder]:
        del previous_ensemble, previous_ensemble_reports, all_reports, config
        pool = _normalize_pool(self._candidate_pool, iteration_number)
        return [_BuilderFromSubestimator(name, sub) for name, sub in pool.items()]
