"""The per-iteration engine: build candidates, train them step by step.

Port of adanet_tpu/core/iteration.py. The JAX package compiles every
candidate's forward, backward and update into one jitted program; here
`Iteration.train_step` is one Python step over all candidates:

1. the frozen members of the previous ensemble run forward once, without
   gradients, shared by every candidate; from them the distillation
   teachers (`TrainLossContext`);
2. each new subnetwork runs its training forward and its backward on its
   own loss (the head's, or the builder's `build_subnetwork_loss` with
   the teachers);
3. each ensemble candidate combines its members' outputs of step 1 and 2,
   detached (so taken before this step's subnetwork updates, as the JAX
   step reads them), and its mixture weights get the gradient of
   loss + complexity regularization; with `use_fused_combine` this is K1
   forward and K1's plain backward;
4. every optimizer steps, and a `tree_where` on the device keeps or
   drops the step: a non-finite loss or gradient (or a dead subnetwork)
   leaves the parameters, the optimizer's slots and counts and the
   buffers its training forward moved (batch-norm statistics, the
   drop-path schedule) as they were, as the JAX step's `tree_where`
   does, and a non-finite subnetwork loss marks it dead. The flags, the
   subnetworks' `step` and `dead`, stay on the device: a step reads
   nothing on the host, so `train_steps` runs a window of K steps back
   to back and the caller reads the counters once a window
   (`host_counters`);
5. each ensemble candidate's zero-debiased loss EMA is updated on the
   device (`core/candidate.py`), quarantining non-finite losses.

Training state is the subnetworks' `nn.Module`s with their
`torch.optim` optimizers, the mixture weights as one `nn.Parameter` per
member, and the candidates' EMA tensors (`IterationState`).
`state_payload` takes all of it, with the dropout generator's state, as
checkpoint data, and `restore_state` loads such a payload onto the
`init_state` of a freshly built `Iteration`, copying into the existing
tensors so that the optimizers keep their parameters; it reads the
device counters, which happens where checkpoints are taken, at a
window's end. A builder's optimizer factory takes the module's
`(name, parameter)` pairs, so that a rule may go by name (weight decay
on kernels only); an optimizer that keeps its step count on the host
unless `capturable` (Adam and its kin) is made capturable on the card,
so that the count stays on the device too. Matrix products run with
TF32 off. With `step_compute_dtype` (`utils/precision.py`) the float
features are cast to it at the step's boundary.

With a `weight_key`, `split_example_weights` takes the per-example
weights out of the features (the models never see them; they stay f32
under the bf16 policy) and every `head.loss` and `head.eval_metrics`
call gets them. An ensembler's parameters are a tree: `{"weights": [w,
...], "bias": b}` with a tensor or, for multi-head logits, a dict of
tensors by key in each place, or `{}` for a mean ensemble, which has no
optimizer, slots or guard and skips the ensemble update. Bagging (and
with it the teachers' extra batches) and RoundRobin placement come with
later slices.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import inspect
import math
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn

from adanet_tpu_torch._device import resolve_device
from adanet_tpu_torch.core import candidate as candidate_lib
from adanet_tpu_torch.core import checkpoint as ckpt_lib
from adanet_tpu_torch.core.architecture import Architecture
from adanet_tpu_torch.core.frozen import (
    FrozenEnsemble,
    FrozenSubnetwork,
    FrozenWeightedSubnetwork,
)
from adanet_tpu_torch.ensemble.weighted import full_f32_matmul
from adanet_tpu_torch.subnetwork.generator import Subnetwork
from adanet_tpu_torch.utils import precision
from adanet_tpu_torch.utils.batches import to_device
from adanet_tpu_torch.utils.trees import tree_finite, tree_where

# Member references inside an ensemble spec: ("new", builder_name) for a
# subnetwork trained this iteration, ("frozen", index) for a previous member.
_NEW = "new"
_FROZEN = "frozen"


@dataclasses.dataclass
class SubnetworkTrainState:
    """Train state for one candidate subnetwork: `step` (int32) counts
    the updates kept and `dead` (bool) marks a non-finite loss, both 0-d
    tensors on the training device."""

    module: nn.Module
    optimizer: torch.optim.Optimizer
    step: torch.Tensor
    dead: torch.Tensor


@dataclasses.dataclass
class EnsembleTrainState:
    """Train state for one ensemble candidate's ensembler params:
    `{"weights": [nn.Parameter], "bias": nn.Parameter}` (bias only with
    `use_bias`; a dict of parameters by key in each place for multi-head
    logits; `{}` for a mean ensemble) and their optimizer (None when
    untrained)."""

    params: Dict[str, Any]
    optimizer: Optional[torch.optim.Optimizer]


@dataclasses.dataclass
class IterationState:
    """All training state of one AdaNet iteration."""

    subnetworks: Dict[str, SubnetworkTrainState]
    ensembles: Dict[str, EnsembleTrainState]
    candidates: Dict[str, candidate_lib.CandidateState]
    frozen: List[nn.Module]
    iteration_step: int
    # Dropout draws of the training forwards, on the training device.
    generator: torch.Generator


@dataclasses.dataclass(frozen=True)
class SubnetworkSpec:
    """Static description of one subnetwork candidate. `module` holds the
    parameters that the iteration's state trains."""

    name: str
    builder: Any
    module: Any
    optimizer_fn: Any  # [(name, parameter), ...] -> torch.optim.Optimizer
    takes_generator: bool = False


@dataclasses.dataclass(frozen=True)
class EnsembleSpec:
    """Static description of one ensemble candidate x ensembler.

    `track_ema=False` marks the carried-over previous-ensemble candidate:
    its loss EMA stays at the value it finished the previous iteration
    with. `initial_params` carries the previous winner's learned
    ensembler params.
    """

    name: str
    candidate_name: str
    ensembler: Any
    optimizer_fn: Optional[Any]
    members: Tuple[Tuple[str, Any], ...]  # (_NEW, name) | (_FROZEN, index)
    architecture: Architecture
    track_ema: bool = True
    initial_params: Optional[Any] = None
    initial_ema: Optional[float] = None


def split_example_weights(features, weight_key, require=True):
    """`(model_features, weights)`: with a `weight_key`, `features` must
    be a mapping holding that key; the model features leave it out (the
    weights never feed a model) and the weights go to every head loss
    and metric. `weights` is None without a `weight_key`; with
    `require=False` a missing key is tolerated (serving features carry
    no weights)."""
    if weight_key is None:
        return features, None
    if not isinstance(features, Mapping) or weight_key not in features:
        if not require:
            return features, None
        raise ValueError(
            "weight_key=%r is set but the features batch %s; pass "
            "features as a dict holding the per-example weight column."
            % (
                weight_key,
                "is not a mapping"
                if not isinstance(features, Mapping)
                else "with keys %s does not contain it" % sorted(features),
            )
        )
    model_features = {k: v for k, v in features.items() if k != weight_key}
    return model_features, features[weight_key]


def _complexity_regularization(ensemble):
    """The ensemble's complexity penalty; 0 for parameterless ensembles."""
    return getattr(ensemble, "complexity_regularization", 0.0)


def _named_params(params: Dict[str, Any]) -> List[Tuple[str, Any]]:
    """The ensembler params' leaves with their names, in a fixed order:
    the weights (`weights/<i>`, `weights/<i>/<key>` for multi-head),
    then the bias (`bias`, `bias/<key>`), then any other entry by name.
    Empty for a mean ensemble."""
    out: List[Tuple[str, Any]] = []

    def walk(node, name):
        if node is None:
            return
        if isinstance(node, Mapping):
            for key in sorted(node):
                walk(node[key], "%s/%s" % (name, key))
        elif isinstance(node, (list, tuple)):
            for i, item in enumerate(node):
                walk(item, "%s/%d" % (name, i))
        else:
            out.append((name, node))

    for key in ["weights", "bias"] + sorted(k for k in params if k not in ("weights", "bias")):
        if key in params:
            walk(params[key], key)
    return out


def _params_list(params: Dict[str, Any]) -> List[torch.Tensor]:
    """The ensembler params in `_named_params`' order."""
    return [t for _, t in _named_params(params)]


def _params_names(params: Dict[str, Any]) -> List[str]:
    """Names of `_params_list`'s entries, in its order."""
    return [name for name, _ in _named_params(params)]


def _map_params(fn, params):
    """`params` with `fn` applied to each tensor leaf (None stays None)."""
    if params is None:
        return None
    if isinstance(params, Mapping):
        return {key: _map_params(fn, value) for key, value in params.items()}
    if isinstance(params, (list, tuple)):
        return [_map_params(fn, item) for item in params]
    return fn(params)


def _as_parameters(params: Dict[str, Any], device) -> Dict[str, Any]:
    """Ensembler params as trainable `nn.Parameter`s on `device` (one
    per member weight, and per key, so that each gets its own gradient);
    a `None` bias is dropped."""

    def param(t):
        return nn.Parameter(torch.as_tensor(t, dtype=torch.float32).detach().clone().to(device))

    return {key: _map_params(param, value) for key, value in params.items() if value is not None}


def state_payload(state: "IterationState") -> Dict[str, Any]:
    """All of `state` as checkpoint data on the CPU (`checkpoint.plain`):
    per subnetwork its `state_dict` (buffers included: batch-norm
    statistics and count, the drop-path schedule's step), its
    optimizer's `state_dict` (with `Chain`'s count) beside the names of
    the parameters it holds state for, `step` and `dead`; per ensemble
    its params and optimizer state; per candidate its EMA tensors; the
    iteration step; the training generator's device and state."""
    return ckpt_lib.plain(
        {
            "iteration_step": int(state.iteration_step),
            "subnetworks": {
                name: {
                    "module": st.module.state_dict(),
                    "optimizer": st.optimizer.state_dict(),
                    "parameter_names": [n for n, _ in st.module.named_parameters()],
                    "step": int(st.step),
                    "dead": bool(st.dead),
                }
                for name, st in state.subnetworks.items()
            },
            "ensembles": {
                name: {
                    "params": _params_list(est.params),
                    "optimizer": None if est.optimizer is None else est.optimizer.state_dict(),
                    "parameter_names": _params_names(est.params),
                }
                for name, est in state.ensembles.items()
            },
            "candidates": {
                name: {f.name: getattr(cs, f.name) for f in dataclasses.fields(cs)}
                for name, cs in state.candidates.items()
            },
            "generator": {"device": state.generator.device.type, "state": state.generator.get_state()},
        }
    )


def _check_names(what: str, saved, rebuilt) -> None:
    if list(saved) != list(rebuilt):
        raise ValueError(
            "The checkpoint's %s do not match the rebuilt iteration's (the generator must be deterministic):\n"
            "checkpoint: %s\nrebuilt: %s" % (what, list(saved), list(rebuilt))
        )


def restore_state(state: "IterationState", payload: Dict[str, Any], restore_generator: bool = True):
    """Loads a `state_payload` onto `state`, the `init_state` of the same
    iteration rebuilt: module and optimizer `state_dict`s (after the
    parameter names are checked, since optimizer state is loaded by
    position), the ensemble params copied in place, the candidates' EMA
    tensors, the step counters and, when training goes on
    (`restore_generator`), the generator's state, which must come from
    the same device type. A mismatch raises `ValueError`."""
    _check_names("subnetworks", sorted(payload["subnetworks"]), sorted(state.subnetworks))
    _check_names("ensembles", sorted(payload["ensembles"]), sorted(state.ensembles))
    _check_names("candidates", sorted(payload["candidates"]), sorted(state.candidates))
    for name, st in state.subnetworks.items():
        saved = payload["subnetworks"][name]
        _check_names("parameters of %r" % name, saved["parameter_names"], [n for n, _ in st.module.named_parameters()])
        st.module.load_state_dict(saved["module"])
        st.optimizer.load_state_dict(saved["optimizer"])
        st.step = torch.tensor(int(saved["step"]), dtype=torch.int32, device=st.step.device)
        st.dead = torch.tensor(bool(saved["dead"]), device=st.dead.device)
    for name, est in state.ensembles.items():
        saved = payload["ensembles"][name]
        _check_names("mixture parameters of %r" % name, saved["parameter_names"], _params_names(est.params))
        with torch.no_grad():
            for param, value in zip(_params_list(est.params), saved["params"]):
                param.copy_(value)
        if (est.optimizer is None) != (saved["optimizer"] is None):
            raise ValueError("The checkpoint's ensemble %r differs from the rebuilt one in being trained" % name)
        if est.optimizer is not None:
            est.optimizer.load_state_dict(saved["optimizer"])
    for name, cs in state.candidates.items():
        device = cs.ema_biased.device
        state.candidates[name] = candidate_lib.CandidateState(
            **{key: value.to(device) for key, value in payload["candidates"][name].items()}
        )
    state.iteration_step = int(payload["iteration_step"])
    if restore_generator:
        saved = payload["generator"]["device"]
        here = state.generator.device.type
        if saved != here:
            raise ValueError(
                "The checkpoint's training generator is a %s generator; training cannot resume on %s "
                "(its draws would differ). Resume on %s, or evaluate from this checkpoint." % (saved, here, saved)
            )
        state.generator.set_state(payload["generator"]["state"])
    return state


def _cut(t):
    """`t` cut from its graph (the JAX `stop_gradient`), dicts (multi-head
    outputs) by key."""
    if isinstance(t, Mapping):
        return {key: _cut(value) for key, value in t.items()}
    return t.detach() if torch.is_tensor(t) else t


def _detached(out: Subnetwork) -> Subnetwork:
    """A forward's outputs cut from its graph."""
    return dataclasses.replace(out, last_layer=_cut(out.last_layer), logits=_cut(out.logits))


def _grads(loss, params):
    """d loss / d params, zeros for a parameter the loss does not reach."""
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]


def _step(optimizer, params, grads) -> None:
    for p, g in zip(params, grads):
        p.grad = g
    optimizer.step()
    optimizer.zero_grad(set_to_none=True)


def _takes_generator(module) -> bool:
    return "generator" in inspect.signature(module.forward).parameters


def _guarded(module: Optional[nn.Module], optimizer) -> List[Tuple[tuple, torch.Tensor]]:
    """Every tensor an update may change, keyed, in a fixed order: the
    optimizer's parameters, their slots and its groups' tensors (a
    count), and the module's buffers (moved by the training forward)."""
    out: List[Tuple[tuple, torch.Tensor]] = []
    for g, group in enumerate(optimizer.param_groups):
        for i, p in enumerate(group["params"]):
            out.append((("param", g, i), p))
            for key, value in sorted(optimizer.state.get(p, {}).items()):
                if torch.is_tensor(value):
                    out.append((("slot", g, i, key), value))
        for key, value in sorted(group.items()):
            if key != "params" and torch.is_tensor(value):
                out.append((("group", g, key), value))
    if module is not None:
        out += [(("buffer", name), b) for name, b in module.named_buffers()]
    return out


def _by_dtype(named) -> Dict[Tuple[Any, torch.dtype], List[Tuple[tuple, torch.Tensor]]]:
    groups: Dict[Tuple[Any, torch.dtype], List[Tuple[tuple, torch.Tensor]]] = {}
    for key, t in named:
        groups.setdefault((t.device, t.dtype), []).append((key, t))
    return groups


def _flat(tensors) -> torch.Tensor:
    return torch.cat([t.detach().reshape(-1) for t in tensors])


class _Guard:
    """Keeps or drops one update on the device: `_Guard(module,
    optimizer)` takes one flat copy per (device, dtype) of what the
    update may change (`_guarded`), a few kernels for the thousands of
    tensors of a NASNet; after the update `keep(ok)` writes
    `tree_where(ok, now, before)` back into the live tensors. A slot the
    optimizer creates in its first step was zeros before it."""

    def __init__(self, module: Optional[nn.Module], optimizer):
        self._module, self._optimizer = module, optimizer
        with torch.no_grad():
            self._before = {
                group: ([key for key, _ in items], [t.numel() for _, t in items], _flat([t for _, t in items]))
                for group, items in _by_dtype(_guarded(module, optimizer)).items()
            }

    def _old(self, group, items) -> torch.Tensor:
        """The flat copy of `items` from before the update."""
        keys, sizes, flat = self._before.get(group, ([], [], None))
        if keys == [key for key, _ in items]:
            return flat
        parts = dict(zip(keys, flat.split(sizes))) if flat is not None else {}
        return torch.cat([parts.get(key, torch.zeros_like(t).reshape(-1)) for key, t in items])

    def keep(self, ok: torch.Tensor) -> None:
        """Leaves the update where `ok` (a 0-d bool tensor) holds, else
        puts everything back as it was."""
        with torch.no_grad():
            for group, items in _by_dtype(_guarded(self._module, self._optimizer)).items():
                now = [t for _, t in items]
                (flat,) = tree_where(ok, [_flat(now)], [self._old(group, items)])
                torch._foreach_copy_(now, [v.view_as(t) for v, t in zip(flat.split([t.numel() for t in now]), now)])


def _counts_on_device(optimizer) -> None:
    """Adam and its kin keep their step count on the host unless
    `capturable`; on the card they are made capturable, so that the
    count is a device tensor that `_Guard` keeps or drops with the rest
    (the update is the same computation, with the bias corrections in
    f32 on the device)."""
    for group in optimizer.param_groups:
        if "capturable" in group and any(p.is_cuda for p in group["params"]):
            group["capturable"] = True


class TrainLossContext:
    """Teacher signals for `Builder.build_subnetwork_loss` (JAX:
    `TrainLossContext`), both detached:

    - `previous_ensemble_logits`: the previous ensemble's logits on this
      batch (ADAPTIVE distillation; reference:
      research/improve_nas/trainer/improve_nas.py:166-172), combined on
      first read, once a step (one K1 launch with the fused combine);
    - `previous_subnetwork_logits`: the last frozen member's logits
      (BORN_AGAIN distillation; improve_nas.py:174-180).
    """

    def __init__(self, ensembler, params, frozen_outs):
        self._ensembler = ensembler
        self._params = params
        self._frozen_outs = frozen_outs
        self.previous_subnetwork_logits = _cut(frozen_outs[-1].logits)

    @functools.cached_property
    def previous_ensemble_logits(self) -> torch.Tensor:
        with torch.no_grad():
            return self._ensembler.build_ensemble(self._params, self._frozen_outs).logits


class Iteration:
    """One AdaNet iteration: candidates, steps and state management."""

    def __init__(
        self,
        iteration_number: int,
        subnetwork_specs: Sequence[SubnetworkSpec],
        ensemble_specs: Sequence[EnsembleSpec],
        frozen_subnetworks: Sequence[FrozenSubnetwork],
        head,
        adanet_loss_decay: float = 0.9,
        previous_ensemble: Optional[FrozenEnsemble] = None,
        collect_summaries: bool = True,
        device=None,
        step_compute_dtype=None,
        weight_key: Optional[str] = None,
    ):
        if not ensemble_specs:
            raise ValueError("An iteration needs at least one ensemble spec.")
        # Per-example weights under this features key feed every head
        # loss and metric (`split_example_weights`).
        self.weight_key = weight_key
        self.iteration_number = iteration_number
        self.subnetwork_specs = list(subnetwork_specs)
        self.ensemble_specs = list(ensemble_specs)
        self.frozen_subnetworks = list(frozen_subnetworks)
        self.head = head
        self.adanet_loss_decay = float(adanet_loss_decay)
        self.collect_summaries = bool(collect_summaries)
        self.previous_ensemble = previous_ensemble
        self.device = resolve_device(device)
        # The bf16 step policy (utils/precision.py): float features are
        # cast to this dtype once, at the train step's boundary.
        self.step_compute_dtype = precision.resolve_dtype(step_compute_dtype)
        self._spec_by_name = {s.name: s for s in self.ensemble_specs}

    # ------------------------------------------------------------------ init

    def init_state(self, generator: torch.Generator, sample_batch) -> IterationState:
        """Initializes every candidate's parameters and optimizer state,
        drawing from `generator` (a CPU `torch.Generator`)."""
        features, _ = to_device(sample_batch, self.device)
        features, _ = split_example_weights(features, self.weight_key, require=False)
        sub_states = {}
        sub_outs = {}
        for spec in self.subnetwork_specs:
            module = spec.module
            init = getattr(module, "init_parameters", None)
            if init is not None:
                init(generator)
            self._graft_initial_variables(spec)
            module.to(self.device)
            optimizer = spec.optimizer_fn(list(module.named_parameters()))
            _counts_on_device(optimizer)
            sub_states[spec.name] = SubnetworkTrainState(
                module=module,
                optimizer=optimizer,
                step=torch.zeros((), dtype=torch.int32, device=self.device),
                dead=torch.zeros((), dtype=torch.bool, device=self.device),
            )
            with torch.no_grad():
                sub_outs[spec.name] = module(features, training=False)

        frozen_modules = [fs.module for fs in self.frozen_subnetworks]
        frozen_outs = self.frozen_outputs(frozen_modules, features)

        ens_states = {}
        cand_states = {}
        for espec in self.ensemble_specs:
            if espec.initial_params is not None:
                params = espec.initial_params
            else:
                member_outs = self.member_outputs(espec, sub_outs, frozen_outs)
                params = espec.ensembler.init_ensemble(
                    generator, member_outs, previous_params=self._warm_start_params(espec)
                )
            params = _as_parameters(params, self.device)
            optimizer = espec.optimizer_fn(_params_list(params)) if espec.optimizer_fn is not None else None
            if optimizer is not None:
                _counts_on_device(optimizer)
            ens_states[espec.name] = EnsembleTrainState(params=params, optimizer=optimizer)
            initial_ema = espec.initial_ema
            if initial_ema is not None and not math.isfinite(initial_ema):
                initial_ema = None
            cand_states[espec.name] = candidate_lib.initial_candidate_state(
                self.device, initial_ema, self.adanet_loss_decay
            )

        seed = int(torch.randint(0, 2**62, (), generator=generator))
        return IterationState(
            subnetworks=sub_states,
            ensembles=ens_states,
            candidates=cand_states,
            frozen=frozen_modules,
            iteration_step=0,
            generator=torch.Generator(device=self.device).manual_seed(seed),
        )

    @staticmethod
    def _graft_initial_variables(spec: SubnetworkSpec) -> None:
        """Loads a builder's `initial_variables` (a `state_dict`, e.g. from
        `utils.convert`) over the random init; a mismatch of names or
        shapes fails here."""
        initial = getattr(spec.builder, "initial_variables", None)
        if not initial:
            return
        expected = spec.module.state_dict()
        got = {key: tuple(torch.as_tensor(v).shape) for key, v in initial.items()}
        want = {key: tuple(v.shape) for key, v in expected.items()}
        if got != want:
            raise ValueError(
                "initial_variables for builder %r do not match the module's "
                "parameters.\nExpected: %s\nGot: %s" % (spec.name, want, got)
            )
        spec.module.load_state_dict({key: torch.as_tensor(v) for key, v in initial.items()})

    def _warm_start_params(self, espec: EnsembleSpec):
        """Previous mixture weights aligned with this spec's members: kept
        members reuse their learned weight; the bias prior is passed only
        when the previous ensemble was kept in full (not pruned)."""
        prev = self.previous_ensemble
        if prev is None or prev.ensembler_params is None:
            return None
        if espec.ensembler.name != prev.ensembler_name:
            return None
        prev_weights = prev.ensembler_params.get("weights")
        if prev_weights is None:
            return None
        prev_index = {id(ws.subnetwork): i for i, ws in enumerate(prev.weighted_subnetworks)}
        weights = []
        num_kept = 0
        for kind, ref in espec.members:
            idx = prev_index.get(id(self.frozen_subnetworks[ref])) if kind == _FROZEN else None
            if idx is not None and idx < len(prev_weights):
                weights.append(prev_weights[idx])
                num_kept += 1
            else:
                weights.append(None)
        kept_all = num_kept == len(prev.weighted_subnetworks)
        bias = prev.ensembler_params.get("bias") if kept_all else None
        if not any(w is not None for w in weights) and bias is None:
            return None
        return {"weights": weights, "bias": bias}

    # ----------------------------------------------------------------- train

    def build_loss_context(self, prev_ensembler_params, frozen_outs) -> Optional[TrainLossContext]:
        """The distillation teachers from the frozen previous ensemble,
        through the first ensemble spec's ensembler (the carried-over
        previous ensemble); None without a previous ensemble."""
        if not frozen_outs or self.previous_ensemble is None:
            return None
        return TrainLossContext(self.ensemble_specs[0].ensembler, prev_ensembler_params, frozen_outs)

    def frozen_outputs(self, frozen_modules, features):
        """Forward passes of the frozen members, without gradients."""
        with torch.no_grad():
            return [module(features, training=False) for module in frozen_modules]

    def member_outputs(self, espec, sub_outs, frozen_outs):
        """Resolves an ensemble spec's member refs to concrete outputs."""
        return [sub_outs[ref] if kind == _NEW else frozen_outs[ref] for kind, ref in espec.members]

    def builder_summary_metrics(self, spec, out, features, labels):
        """Metrics from `Builder.build_subnetwork_summaries`, keyed
        `summary/<subnetwork>/<tag>`; none when summaries are off."""
        if not self.collect_summaries:
            return {}
        hook = getattr(spec.builder, "build_subnetwork_summaries", None)
        extra = hook(out, features, labels) if hook else None
        return {
            "summary/%s/%s" % (spec.name, tag): value.detach() if torch.is_tensor(value) else value
            for tag, value in (extra or {}).items()
        }

    def train_step(self, state: IterationState, batch):
        """One step over every candidate on a (features, labels) batch.
        Returns (state, metrics), metrics as 0-d tensors. Nothing is read
        on the host."""
        with full_f32_matmul():
            return self._train_step(state, batch)

    def train_steps(self, state: IterationState, batches):
        """K steps back to back, one a batch of `batches` (the JAX
        `train_steps`, whose K steps are one `lax.scan`): no host read
        between them, since a step reads none. Returns (state, the last
        step's metrics); K single `train_step`s give the same state."""
        metrics = None
        for batch in batches:
            state, metrics = self.train_step(state, batch)
        return state, metrics

    def host_counters(self, state: IterationState) -> Dict[str, Tuple[int, bool]]:
        """Each subnetwork's (updates kept, dead), in one host read."""
        names = list(state.subnetworks)
        values = torch.stack(
            [t for n in names for t in (state.subnetworks[n].step, state.subnetworks[n].dead.to(torch.int32))]
        ).tolist() if names else []
        return {n: (values[2 * i], bool(values[2 * i + 1])) for i, n in enumerate(names)}

    def _train_step(self, state: IterationState, batch):
        features, labels = to_device(batch, self.device)
        # The weights stay f32 under the bf16 policy: they are split out
        # before the cast.
        features, weights = split_example_weights(features, self.weight_key)
        if self.step_compute_dtype is not None:
            features = precision.cast_floats(features, self.step_compute_dtype)
        metrics: Dict[str, Any] = {}

        # 1) The frozen members, once for every candidate, and the
        #    distillation teachers from them.
        frozen_outs = self.frozen_outputs(state.frozen, features)
        context = self.build_loss_context(state.ensembles[self.ensemble_specs[0].name].params, frozen_outs)

        # 2) Every new subnetwork on its own loss.
        sub_outs = {}
        sub_updates = []
        for spec in self.subnetwork_specs:
            st = state.subnetworks[spec.name]
            kwargs = {"generator": state.generator} if spec.takes_generator else {}
            guard = _Guard(st.module, st.optimizer)
            out = st.module(features, training=True, **kwargs)
            loss = spec.builder.build_subnetwork_loss(out, labels, self.head, context)
            if loss is None:
                loss = self.head.loss(out.logits, labels, weights)
            params = list(st.module.parameters())
            grads = _grads(loss, params)
            finite = torch.isfinite(loss)
            sub_updates.append((st, params, grads, guard, finite & tree_finite(grads) & ~st.dead, finite))
            metrics.update(self.builder_summary_metrics(spec, out, features, labels))
            sub_outs[spec.name] = _detached(out)
            metrics["subnetwork_loss/%s" % spec.name] = loss.detach()

        # 3) Every ensemble candidate's mixture weights on loss +
        #    complexity regularization, members as step 2 left them; a
        #    candidate without an optimizer (untrained, or a mean
        #    ensemble) only computes its loss.
        ens_updates = []
        for espec in self.ensemble_specs:
            est = state.ensembles[espec.name]
            member_outs = self.member_outputs(espec, sub_outs, frozen_outs)
            with torch.set_grad_enabled(est.optimizer is not None):
                ens = espec.ensembler.build_ensemble(est.params, member_outs)
                loss = self.head.loss(ens.logits, labels, weights)
                adanet_loss = loss + _complexity_regularization(ens)
            if est.optimizer is not None:
                params = _params_list(est.params)
                grads = _grads(adanet_loss, params)
                ens_updates.append((est, params, grads, torch.isfinite(adanet_loss) & tree_finite(grads)))
            if espec.track_ema:
                state.candidates[espec.name] = candidate_lib.update_candidate_state(
                    state.candidates[espec.name], adanet_loss, self.adanet_loss_decay
                )
            metrics["adanet_loss/%s" % espec.name] = adanet_loss.detach()
            metrics["ensemble_loss/%s" % espec.name] = loss.detach()

        # 4) Every optimizer steps; what was not finite is put back on
        #    the device.
        for st, params, grads, guard, ok, finite in sub_updates:
            _step(st.optimizer, params, grads)
            guard.keep(ok)
            st.step = st.step + ok.to(torch.int32)
            st.dead = st.dead | ~finite
        for est, params, grads, ok in ens_updates:
            guard = _Guard(None, est.optimizer)
            _step(est.optimizer, params, grads)
            guard.keep(ok)
        state.iteration_step += 1
        return state, metrics

    # ------------------------------------------------------------------ eval

    def eval_step(self, state: IterationState, batch):
        """Every candidate's losses and head metrics on one batch."""
        with full_f32_matmul(), torch.no_grad():
            features, labels = to_device(batch, self.device)
            features, weights = split_example_weights(features, self.weight_key)
            sub_outs = {
                spec.name: state.subnetworks[spec.name].module(features, training=False)
                for spec in self.subnetwork_specs
            }
            frozen_outs = self.frozen_outputs(state.frozen, features)
            results = {}
            for espec in self.ensemble_specs:
                member_outs = self.member_outputs(espec, sub_outs, frozen_outs)
                ens = espec.ensembler.build_ensemble(state.ensembles[espec.name].params, member_outs)
                loss = self.head.loss(ens.logits, labels, weights)
                out = {"loss": loss, "adanet_loss": loss + _complexity_regularization(ens)}
                out.update(self.head.eval_metrics(ens.logits, labels, weights))
                results[espec.name] = out
            for spec in self.subnetwork_specs:
                results["subnetwork/%s" % spec.name] = {
                    "loss": self.head.loss(sub_outs[spec.name].logits, labels, weights)
                }
            return results

    def candidate_forward(self, state: IterationState, name: str, features):
        """The ensemble candidate `name` on `features` (the weight column,
        if any, left out), as the mid-iteration state holds it (no
        gradients); returns its `Ensemble`."""
        espec = self._spec_by_name[name]
        features, _ = split_example_weights(features, self.weight_key, require=False)
        with full_f32_matmul(), torch.no_grad():
            outs = [
                (state.subnetworks[ref].module if kind == _NEW else state.frozen[ref])(features, training=False)
                for kind, ref in espec.members
            ]
            return espec.ensembler.build_ensemble(state.ensembles[name].params, outs)

    # ------------------------------------------------------- selection/freeze

    def candidate_names(self) -> List[str]:
        return [spec.name for spec in self.ensemble_specs]

    def ema_losses(self, state: IterationState) -> Dict[str, float]:
        """Zero-debiased EMA per candidate (inf when dead or unset)."""
        names = list(state.candidates)
        values = torch.stack(
            [candidate_lib.debiased_ema(state.candidates[n], self.adanet_loss_decay) for n in names]
        ).tolist()
        return dict(zip(names, values))

    def best_candidate_index(
        self,
        state: IterationState,
        override: Optional[int] = None,
        exclude_first: bool = False,
    ) -> int:
        """Argmin over candidate EMAs. Non-finite candidates are never
        selected; if every candidate is dead this raises.
        `exclude_first=True` implements `force_grow` at t>0: the
        carried-over previous ensemble is ignored."""
        if override is not None:
            return int(override)
        emas = self.ema_losses(state)
        losses = [emas[spec.name] for spec in self.ensemble_specs]
        start = 1 if exclude_first and len(losses) > 1 else 0
        candidates = list(range(start, len(losses)))
        finite = [i for i in candidates if losses[i] != float("inf")]
        if not finite:
            raise FloatingPointError(
                "All %d ensemble candidates have non-finite AdaNet losses." % len(candidates)
            )
        return int(min(finite, key=lambda i: losses[i]))

    def freeze_candidate(self, state: IterationState, spec_name: str, sample_batch) -> FrozenEnsemble:
        """Freezes a candidate into the records the next iteration grows
        from: a copy of each new member's module (parameters as trained,
        no gradients) with its complexity and `shared` payload from a
        forward on `sample_batch`, and a copy of the mixture weights."""
        espec = self._spec_by_name[spec_name]
        features, _ = to_device(sample_batch, self.device)
        features, _ = split_example_weights(features, self.weight_key, require=False)
        ensembler_params = _map_params(lambda t: t.detach().clone(), state.ensembles[espec.name].params)
        weights = ensembler_params.get("weights")

        weighted = []
        for i, (kind, ref) in enumerate(espec.members):
            if kind == _FROZEN:
                frozen = self.frozen_subnetworks[ref]
            else:
                spec = next(s for s in self.subnetwork_specs if s.name == ref)
                module = copy.deepcopy(state.subnetworks[spec.name].module)
                module.requires_grad_(False).eval()
                with full_f32_matmul(), torch.no_grad():
                    out = module(features, training=False)
                complexity = out.complexity
                if torch.is_tensor(complexity):
                    complexity = float(complexity)
                to_spec = getattr(spec.builder, "to_spec", None)
                frozen = FrozenSubnetwork(
                    iteration_number=self.iteration_number,
                    name=spec.name,
                    module=module,
                    complexity=complexity,
                    shared=out.shared,
                    builder_spec=to_spec() if to_spec is not None else None,
                )
            weight = weights[i] if weights is not None and i < len(weights) else None
            weighted.append(FrozenWeightedSubnetwork(subnetwork=frozen, weight=weight))

        return FrozenEnsemble(
            name=espec.name,
            iteration_number=self.iteration_number,
            weighted_subnetworks=weighted,
            ensembler_name=espec.ensembler.name,
            ensembler_params=ensembler_params,
            architecture=espec.architecture,
            final_ema=self.ema_losses(state).get(espec.name),
        )


class IterationBuilder:
    """Builds `Iteration`s from builders, strategies and ensemblers."""

    def __init__(
        self,
        head,
        ensemblers: Sequence[Any],
        ensemble_strategies: Sequence[Any],
        adanet_loss_decay: float = 0.9,
        collect_summaries: bool = True,
        device=None,
        step_compute_dtype=None,
        weight_key: Optional[str] = None,
    ):
        if not ensemblers:
            raise ValueError("At least one ensembler is required.")
        if not ensemble_strategies:
            raise ValueError("At least one ensemble strategy is required.")
        self._head = head
        self._ensemblers = list(ensemblers)
        self._strategies = list(ensemble_strategies)
        self._adanet_loss_decay = float(adanet_loss_decay)
        self._collect_summaries = bool(collect_summaries)
        self._device = resolve_device(device)
        self._step_compute_dtype = precision.resolve_dtype(step_compute_dtype)
        self._weight_key = weight_key

    def _ensembler_by_name(self, name: str):
        for ensembler in self._ensemblers:
            if ensembler.name == name:
                return ensembler
        raise ValueError(
            "Previous ensemble was built by ensembler %r which is not among this run's "
            "ensemblers %s." % (name, [e.name for e in self._ensemblers])
        )

    def build_iteration(
        self,
        iteration_number: int,
        subnetwork_builders: Sequence[Any],
        previous_ensemble: Optional[FrozenEnsemble] = None,
        *,
        input_shape: Sequence[int],
    ) -> Iteration:
        """The iteration's candidates; `input_shape` is one example's
        feature shape, which the builders' torch modules are built for."""
        if not subnetwork_builders:
            raise ValueError("Need at least one subnetwork builder.")
        names = [b.name for b in subnetwork_builders]
        if len(set(names)) != len(names):
            raise ValueError("Builder names must be unique, got %s" % names)

        logits_dimension = self._head.logits_dimension
        frozen_members: List[FrozenSubnetwork] = (
            list(previous_ensemble.subnetworks) if previous_ensemble else []
        )
        frozen_index = {id(fs): i for i, fs in enumerate(frozen_members)}

        subnetwork_specs = []
        for builder in subnetwork_builders:
            module = builder.build_subnetwork(
                logits_dimension, previous_ensemble=previous_ensemble, input_shape=tuple(input_shape)
            )
            subnetwork_specs.append(
                SubnetworkSpec(
                    name=builder.name,
                    builder=builder,
                    module=module,
                    optimizer_fn=builder.build_train_optimizer(previous_ensemble=previous_ensemble),
                    takes_generator=_takes_generator(module),
                )
            )

        ensemble_specs = []
        seen = set()
        # At t>0 the zero-th candidate is the carried-over previous
        # ensemble, competing at its frozen loss EMA with its frozen params.
        if previous_ensemble is not None:
            ensemble_specs.append(
                EnsembleSpec(
                    name=previous_ensemble.name,
                    candidate_name=previous_ensemble.name,
                    ensembler=self._ensembler_by_name(previous_ensemble.ensembler_name),
                    optimizer_fn=None,
                    members=tuple((_FROZEN, i) for i in range(len(frozen_members))),
                    architecture=previous_ensemble.architecture,
                    track_ema=False,
                    initial_params=previous_ensemble.ensembler_params,
                    initial_ema=previous_ensemble.final_ema,
                )
            )
            seen.add(previous_ensemble.name)
        for strategy in self._strategies:
            candidates = strategy.generate_ensemble_candidates(
                subnetwork_builders, frozen_members or None
            )
            for cand in candidates:
                for ensembler in self._ensemblers:
                    # Reference naming: "t{}_{}_{}" with the ensembler name
                    # always appended (reference: iteration.py:694-697).
                    name = "t{}_{}_{}".format(iteration_number, cand.name, ensembler.name)
                    if name in seen:
                        raise ValueError("Duplicate ensemble candidate name %r" % name)
                    seen.add(name)
                    members: List[Tuple[str, Any]] = []
                    architecture = Architecture(
                        ensemble_candidate_name=cand.name,
                        ensembler_name=ensembler.name,
                        iteration_number=iteration_number,
                        replay_indices=(
                            previous_ensemble.architecture.replay_indices if previous_ensemble else []
                        ),
                    )
                    for frozen in cand.previous_ensemble_subnetworks:
                        members.append((_FROZEN, frozen_index[id(frozen)]))
                        architecture.add_subnetwork(frozen.iteration_number, frozen.name)
                    for builder in cand.subnetwork_builders:
                        members.append((_NEW, builder.name))
                        architecture.add_subnetwork(iteration_number, builder.name)
                    ensemble_specs.append(
                        EnsembleSpec(
                            name=name,
                            candidate_name=cand.name,
                            ensembler=ensembler,
                            optimizer_fn=ensembler.build_train_optimizer(),
                            members=tuple(members),
                            architecture=architecture,
                        )
                    )

        return Iteration(
            iteration_number=iteration_number,
            subnetwork_specs=subnetwork_specs,
            ensemble_specs=ensemble_specs,
            frozen_subnetworks=frozen_members,
            head=self._head,
            adanet_loss_decay=self._adanet_loss_decay,
            previous_ensemble=previous_ensemble,
            collect_summaries=self._collect_summaries,
            device=self._device,
            step_compute_dtype=self._step_compute_dtype,
            weight_key=self._weight_key,
        )
