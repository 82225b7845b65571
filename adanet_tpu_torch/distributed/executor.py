"""RoundRobin executor: candidate-parallel training across device groups.

Port of adanet_tpu/distributed/executor.py. Each subnetwork trains in
its own group (`RoundRobinStrategy.subnetwork_mesh`) through
`Iteration.subnetwork_update`, and the ensemble group
(`ensemble_mesh`) trains every candidate's mixture weights through
`Iteration.ensemble_update` (K1 with `use_fused_combine`) on member
outputs that it recomputes itself, in eval mode (`training=False`, no
draw), from its own copies of the members' variables. The copies are
cloned (not aliased) every `sync_every` steps, after the subnetworks'
updates: the reference's parameter-server fetch, whose staleness
`sync_every` sets. With batch norm the copies' forwards read the running
statistics.

Staleness contract (the JAX docstring's): subnetwork training is
IDENTICAL to the fused path's (`Iteration.train_step`): the same
batches, the same updates, and the same dropout and stochastic-depth
draws, since the groups draw from the iteration's generator in the order
the fused step does and the ensemble group draws nothing. A bagged
subnetwork is the exception where it draws: the fused step's
training-mode recompute on the shared batch draws again and RoundRobin
has none. The ensemble signal reads members up to `sync_every` steps
stale and, at a sync, one step ahead of the fused step's in-step
forward, so candidate EMAs are not the fused path's;
tests/test_torch_placement.py::test_round_robin_fused_divergence_bounded
holds the bound.

In one process every group must be on the iteration's device (on one
card, every group is the card); groups across several cards in one
process are not ported. Candidate groups across processes are the
multi-host executor's (`multihost.MultiHostRoundRobinExecutor`), which
trains through the same methods: `_trains` picks the groups a process
owns and `_group_scope` sets a group's process group.
"""

from __future__ import annotations

import contextlib
import copy
import functools
import logging
from typing import Dict, Optional

import torch

from adanet_tpu_torch.core import iteration as iteration_lib
from adanet_tpu_torch.core.iteration import Iteration, IterationState
from adanet_tpu_torch.distributed.placement import RoundRobinStrategy
from adanet_tpu_torch.ensemble.weighted import full_f32_matmul
from adanet_tpu_torch.robustness.faults import InjectedFault
from adanet_tpu_torch.robustness.watchdog import PeerLostError
from adanet_tpu_torch.subnetwork.generator import Builder

_LOG = logging.getLogger("adanet_tpu_torch")

#: Failures that quarantine ONE candidate instead of killing the
#: iteration: an injected chaos fault in its dispatch path, or the loss
#: of the peer(s) hosting its group. Anything else propagates: a genuine
#: bug must not be silently absorbed as "candidate died".
CANDIDATE_FAULTS = (InjectedFault, PeerLostError)


def _device_key(device):
    """(type, index) of a device, a bare "cuda" at the current card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return ("cuda", torch.cuda.current_device())
    return (device.type, device.index or 0)


class RoundRobinExecutor:
    """Runs one iteration's training with candidate-parallel placement.

    Holds the same `IterationState` as the fused engine, so evaluation,
    selection, freezing and checkpointing reuse the `Iteration` methods
    unchanged after `gather()`.

    Args:
      iteration: the `Iteration` to train.
      strategy: a `RoundRobinStrategy`; by default one over the
        iteration's device.
      sync_every: steps between the member copies' syncs (1: every step).
    """

    #: Whether the executor spans processes (`MultiHostRoundRobinExecutor`).
    is_multihost = False

    def __init__(self, iteration: Iteration, strategy: Optional[RoundRobinStrategy] = None, sync_every: int = 1):
        if sync_every < 1:
            raise ValueError("sync_every must be >= 1.")
        self.iteration = iteration
        self.strategy = strategy or RoundRobinStrategy([iteration.device])
        self.sync_every = int(sync_every)
        self._host_step = 0
        self._last_sync_step = 0
        # The ensemble group's copies of the members' variables, by
        # subnetwork (None until the first sync).
        self._member_copies: Optional[Dict[str, torch.nn.Module]] = None
        # Quarantined subnetworks and why: a candidate whose dispatch
        # faults freezes at its last good step and the iteration goes on
        # with the survivors (`dead_candidate_names`).
        self._dead_subnetworks: Dict[str, str] = {}
        self._n = len(iteration.subnetwork_specs)
        self._build_meshes()
        # Builders with custom training losses need the distillation
        # teachers: their groups compute the context from the frozen
        # members themselves (every reference worker builds the full graph).
        self._needs_context = {
            spec.name: (
                iteration.previous_ensemble is not None
                and type(spec.builder).build_subnetwork_loss is not Builder.build_subnetwork_loss
            )
            for spec in iteration.subnetwork_specs
        }
        self._teachers = None
        # One step function a subnetwork's group (a test may wrap one to
        # inject a fault into its dispatch).
        self._sub_steps = {
            spec.name: functools.partial(self._subnetwork_step, spec) for spec in iteration.subnetwork_specs
        }

    def _build_meshes(self) -> None:
        """Each group's devices; in one process all must be the
        iteration's device."""
        n = self._n
        self._sub_meshes = {
            spec.name: self.strategy.subnetwork_mesh(n, i) for i, spec in enumerate(self.iteration.subnetwork_specs)
        }
        self._ens_mesh = self.strategy.ensemble_mesh(n)
        groups = [self._ens_mesh] + list(self._sub_meshes.values())
        here = _device_key(self.iteration.device)
        if any(_device_key(group.device) != here for group in groups):
            raise ValueError(
                "RoundRobin groups on %s, but the iteration trains on %s: in one process every group runs on the "
                "iteration's device (placement across several cards in one process is not ported)."
                % (sorted({str(group.device) for group in groups}), self.iteration.device)
            )

    # ----------------------------------------------------- fault quarantine

    def _mark_subnetwork_dead(self, name: str, exc: BaseException) -> None:
        reason = "%s: %s" % (type(exc).__name__, exc)
        self._dead_subnetworks[name] = reason
        _LOG.error("Candidate subnetwork %r quarantined (training continues with survivors): %s", name, reason)

    def dead_subnetworks(self) -> Dict[str, str]:
        """Quarantined subnetworks and why (empty in a healthy run)."""
        return dict(self._dead_subnetworks)

    def dead_candidate_names(self) -> set:
        """Ensemble candidates with a quarantined new member: their
        selection signal read frozen member copies from the fault on, so
        they join the NaN-quarantine path (the estimator forces their
        `CandidateState.dead`)."""
        if not self._dead_subnetworks:
            return set()
        dead = set(self._dead_subnetworks)
        return {
            espec.name
            for espec in self.iteration.ensemble_specs
            if any(kind == iteration_lib._NEW and ref in dead for kind, ref in espec.members)
        }

    # ------------------------------------------------------------------ state

    def init_state(self, generator: torch.Generator, sample_batch) -> IterationState:
        """Initializes the iteration's state and places it."""
        return self.place(self.iteration.init_state(generator, sample_batch))

    def place(self, state: IterationState) -> IterationState:
        """Places `state` on the groups: the teachers for context-needing
        groups (the frozen members and the carried-over ensemble's
        params, which never train in the iteration, so one device's
        groups read them in place), and the member copies dropped, so that
        the first step syncs."""
        it = self.iteration
        prev = it.ensemble_specs[0].name if it.previous_ensemble is not None else None
        self._teachers = (state.frozen, state.ensembles[prev].params if prev is not None else None)
        self._member_copies = None
        return state

    # ------------------------------------------------------------------ train

    def _trains(self, name: str) -> bool:
        """Whether this process trains subnetwork `name` (in one process:
        every subnetwork)."""
        del name
        return True

    def _group_scope(self, name: Optional[str]):
        """A context for one group's update (`name` None: the ensemble
        group); in one process nothing."""
        del name
        return contextlib.nullcontext()

    def _subnetwork_step(self, spec, st, features, labels, weights, context, generator):
        """One subnetwork group's step: `Iteration.subnetwork_update`.
        Returns (loss, the builder's summary metrics)."""
        out, loss = self.iteration.subnetwork_update(
            spec, st, features, labels, context, weights=weights, generator=generator
        )
        return loss, self.iteration.builder_summary_metrics(spec, out, features, labels)

    def _train_subnetworks(self, state: IterationState, inputs, extra_inputs, metrics) -> None:
        """Every live subnetwork group's step on its batch, in the fused
        step's order (so that their draws are the fused step's)."""
        it = self.iteration
        for spec in it.subnetwork_specs:
            if spec.name in self._dead_subnetworks or not self._trains(spec.name):
                continue  # quarantined (frozen at its last good step), or another process's
            features, weights, labels = extra_inputs.get(spec.name, inputs)
            context = None
            if self._needs_context[spec.name]:
                if self._teachers is None:
                    raise ValueError(
                        "State was not placed: call executor.init_state() or executor.place(state) before "
                        "training when builders use custom losses with a previous ensemble."
                    )
                frozen, prev_params = self._teachers
                context = it.build_loss_context(prev_params, it.frozen_outputs(frozen, features))
            try:
                with self._group_scope(spec.name):
                    loss, extra = self._sub_steps[spec.name](
                        state.subnetworks[spec.name], features, labels, weights, context, state.generator
                    )
            except CANDIDATE_FAULTS as exc:
                self._mark_subnetwork_dead(spec.name, exc)
                continue
            metrics["subnetwork_loss/%s" % spec.name] = loss
            metrics.update(extra)

    def _maybe_sync_members(self, state: IterationState) -> None:
        """Clones the members' variables (parameters and buffers) into the
        ensemble group's copies when `sync_every` steps have passed since
        the last sync (a window advances the counter by its K steps, so
        the staleness is max(sync_every, K))."""
        if self._member_copies is not None and self._host_step - self._last_sync_step < self.sync_every:
            return
        self._last_sync_step = self._host_step
        with torch.no_grad():
            if self._member_copies is None:
                self._member_copies = {}
                for name, st in state.subnetworks.items():
                    member = copy.deepcopy(st.module).to(self._ens_mesh.device)
                    self._member_copies[name] = member.requires_grad_(False)
                return
            for name, st in state.subnetworks.items():
                dst = list(self._member_copies[name].state_dict().values())
                torch._foreach_copy_(dst, list(st.module.state_dict().values()))

    def _train_ensembles(self, state: IterationState, inputs, metrics) -> None:
        """The ensemble group's step on the shared batch: member forwards
        in eval mode from the copies, the frozen members, then every
        candidate's `Iteration.ensemble_update`."""
        it = self.iteration
        features, weights, labels = inputs
        with torch.no_grad():
            sub_outs = {
                name: iteration_lib._detached(member(features, training=False))
                for name, member in self._member_copies.items()
            }
        frozen_outs = it.frozen_outputs(state.frozen, features)
        for espec in it.ensemble_specs:
            member_outs = it.member_outputs(espec, sub_outs, frozen_outs)
            with self._group_scope(None):
                state.candidates[espec.name], adanet_loss, loss = it.ensemble_update(
                    espec, state.ensembles[espec.name], state.candidates[espec.name], member_outs, labels, weights
                )
            metrics["adanet_loss/%s" % espec.name] = adanet_loss
            metrics["ensemble_loss/%s" % espec.name] = loss

    def train_step(self, state: IterationState, batch, extra_batches=None):
        """One candidate-parallel step: every subnetwork group's update,
        then the member sync (every `sync_every` steps), then the ensemble
        group's step. `extra_batches` maps subnetwork names to their own
        (features, labels) batch (bagging): the owning group trains on it,
        while the ensemble group's member forwards use the shared batch.
        Returns (state, metrics)."""
        it = self.iteration
        with full_f32_matmul():
            inputs = it._step_inputs(batch)
            extra_inputs = {name: it._step_inputs(b) for name, b in (extra_batches or {}).items()}
            metrics: Dict[str, torch.Tensor] = {}
            self._train_subnetworks(state, inputs, extra_inputs, metrics)
            self._host_step += 1
            self._maybe_sync_members(state)
            self._train_ensembles(state, inputs, metrics)
        state.iteration_step += 1
        return state, metrics

    def train_steps(self, state: IterationState, batches):
        """K candidate-parallel steps, one a batch (the RoundRobin
        `iterations_per_loop`): the subnetwork groups' K updates (step by
        step, so that the draws are those of K single steps), one member
        sync, then the ensemble group's K updates against those copies.
        Returns (state, the last step's metrics)."""
        it = self.iteration
        batches = list(batches)
        with full_f32_matmul():
            inputs = [it._step_inputs(batch) for batch in batches]
            metrics: Dict[str, torch.Tensor] = {}
            for step_inputs in inputs:
                self._train_subnetworks(state, step_inputs, {}, metrics)
            self._host_step += len(batches)
            self._maybe_sync_members(state)
            for step_inputs in inputs:
                self._train_ensembles(state, step_inputs, metrics)
        state.iteration_step += len(batches)
        return state, metrics

    # ------------------------------------------------------------- gather

    def gather(self, state: IterationState) -> IterationState:
        """The state for evaluation and freezing: in one process it is
        already where the iteration's methods read it."""
        return state

    def ema_losses(self, state: IterationState) -> Dict[str, float]:
        return self.iteration.ema_losses(state)
