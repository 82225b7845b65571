"""Multi-host RoundRobin: candidate parallelism across processes.

Port of adanet_tpu/distributed/multihost.py. The `num_subnetworks + 1`
candidate groups (group 0 the ensembles, group i + 1 subnetwork i) are
owned by processes (`multihost_candidate_groups`):

- with at least as many processes as groups, a group is a contiguous
  block of whole processes (the reference's worker partitioning); a
  group of several processes trains its candidate data-parallel over
  its own process group (`torch.distributed.new_group`), with the
  numerator-and-denominator all-reduce of `Iteration._global_means`;
- with fewer processes than groups, group g goes to process g % P (the
  reference's worker-modulo rule) and each process splits its local
  devices among the groups it owns (on one card, every group is that
  card).

The ensemble group always holds process 0, the chief, so that selection
state lives where the bookkeeping is written.

Member sync and the end-of-iteration gather are host broadcasts through
the process group's store (`_broadcast_tree`): every `sync_every` steps
each subnetwork group's first owner publishes its variables (with its
last loss and its quarantine flag) and the ensemble group's owners load
them into their member copies. No device collective carries control or
state: a store wait has a deadline, so a dead peer raises
`PeerLostError` where a collective would wedge the survivor, and the
survivor quarantines every group it can no longer reach
(`_on_peer_lost`) and finishes the iteration with the rest.

Data: every process feeds its own batches (the reference's per-worker
input pipelines); feeding every process the same batches makes each
subnetwork's training the one-process executor's. A process draws its
owned subnetworks' dropout from its copy of the iteration's generator in
the fused step's order, so its draws are the one-process executor's
when the subnetworks owned elsewhere draw nothing (the ResNets and DNNs
do not; EfficientNet's stochastic depth does).
"""

from __future__ import annotations

import contextlib
import copy
import datetime
import logging
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from adanet_tpu_torch.core import iteration as iteration_lib
from adanet_tpu_torch.core.iteration import Iteration, IterationState
from adanet_tpu_torch.distributed import coordination
from adanet_tpu_torch.distributed import mesh as mesh_lib
from adanet_tpu_torch.distributed.executor import RoundRobinExecutor, _device_key
from adanet_tpu_torch.distributed.placement import RoundRobinStrategy
from adanet_tpu_torch.distributed.scheduler import decode_tree, encode_tree
from adanet_tpu_torch.ensemble.weighted import full_f32_matmul
from adanet_tpu_torch.robustness import faults
from adanet_tpu_torch.robustness.watchdog import PeerLostError, call_with_deadline, collective_timeout_secs

_LOG = logging.getLogger("adanet_tpu_torch")


def multihost_candidate_groups(
    num_groups: int,
    devices: Optional[Sequence] = None,
    process_count: Optional[int] = None,
    process_index: Optional[int] = None,
) -> Tuple[List[List], List[List[int]]]:
    """Partitions the processes' devices into process-aligned groups.

    Returns `(groups, owners)`: `owners[g]` the sorted process indices
    owning group g, and `groups[g]` THIS process's devices of group g
    (empty when it owns none of it: a process sees only its own
    devices). `devices` are this process's devices (its CUDA devices by
    default). Group 0 (the ensemble group) always holds process 0. A
    group is either a block of whole processes or a subset of one
    process's devices (reference worker partitioning:
    adanet/distributed/placement.py:196-254).
    """
    if num_groups <= 0:
        raise ValueError("num_groups must be positive.")
    devices = list(devices) if devices is not None else mesh_lib._default_devices()
    num_processes = process_count if process_count is not None else coordination.process_count()
    me = process_index if process_index is not None else coordination.process_index()
    groups: List[List] = [[] for _ in range(num_groups)]
    owners: List[List[int]] = [[] for _ in range(num_groups)]
    if num_processes >= num_groups:
        # Whole-process blocks (contiguous, chief in group 0).
        for g, block in enumerate(np.array_split(np.arange(num_processes), num_groups)):
            owners[g] = block.tolist()
            if me in owners[g]:
                groups[g] = list(devices)
    else:
        # Reference worker-modulo rule: group g -> process g % P; each
        # process splits its devices among the groups it owns.
        owned_by: Dict[int, List[int]] = {}
        for g in range(num_groups):
            owned_by.setdefault(g % num_processes, []).append(g)
        for p, group_ids in owned_by.items():
            for g in group_ids:
                owners[g] = [p]
            if p == me:
                for g, part in zip(group_ids, mesh_lib.partition_devices(devices, len(group_ids))):
                    groups[g] = list(part)
    return groups, owners


#: Store values are chunked at this size (the JAX package's gRPC cap).
_KV_CHUNK_BYTES = 2 << 20
#: Broadcast keys older than this many sequence numbers are deleted by
#: their source. Every process waits on every broadcast it does not
#: source, so processes stay within one round of each other and a
#: 64-sequence lag never deletes a key a receiver still needs.
_KV_GC_LAG = 64
#: Retained payloads live in the store's process (the chief's memory)
#: until deleted; when this process's retained bytes exceed the budget
#: (`ADANET_KV_GC_BYTES`, default 256 MiB), GC tightens to
#: `_KV_GC_MIN_LAG` (`ADANET_KV_GC_MIN_LAG`), which must still exceed
#: one sync round's broadcasts (one a candidate group).
_KV_GC_MIN_LAG = 16
_KV_GC_DEFAULT_BYTES = 256 << 20

_broadcast_seq = [0]
_kv_keys_set: list = []  # (seq, [keys], nbytes) this process wrote
_kv_bytes_retained = [0]
#: The most bytes this process kept in the store after a broadcast's GC.
kv_bytes_retained_peak = [0]


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    try:
        return int(raw)
    except ValueError:
        _LOG.warning("Ignoring non-integer %s=%r.", name, raw)
        return default


def _kv_gc_limits() -> Tuple[int, int]:
    """(min_lag, byte_budget) for source-side GC, env-overridable."""
    return (
        max(1, _env_int("ADANET_KV_GC_MIN_LAG", _KV_GC_MIN_LAG)),
        max(0, _env_int("ADANET_KV_GC_BYTES", _KV_GC_DEFAULT_BYTES)),
    )


def _store():
    return dist.distributed_c10d._get_default_store()


def _broadcast_tree(payload, is_source: bool, template=None, want: bool = True, publish: bool = True,
                    timeout_secs: Optional[float] = None, label: str = "broadcast"):
    """A tree of tensors from one process to the others, through the
    process group's store.

    The source encodes `payload` (`encode_tree`, one blob) in
    `_KV_CHUNK_BYTES` chunks under `adanet/bcast/<seq>/`, then their
    count, and returns it; without `publish` (no process wants the data)
    it writes only a count of 0. A receiver waits for the count, bounded
    by `timeout_secs` (the collective deadline by default), and with
    `want` reads the chunks and returns the tree decoded onto
    `template`'s devices; without `want` it only waits (the round's
    barrier) and returns None. A failed wait raises `PeerLostError`. No device collective is involved: a
    collective whose peer died blocks with no deadline, which would
    wedge the survivor (the JAX package's design note, multihost.py:
    191-294).

    Sequence numbers line up because every process calls this in the
    same program order; sources delete their own keys `_KV_GC_LAG`
    sequences later (sooner past the byte budget)."""
    faults.trip("collective.entry")
    seq = _broadcast_seq[0]
    _broadcast_seq[0] += 1
    if coordination.process_count() <= 1:
        return payload
    store = _store()
    prefix = "adanet/bcast/%d" % seq
    if is_source:
        blob = encode_tree(payload) if publish else b""
        nchunks = -(-len(blob) // _KV_CHUNK_BYTES)
        keys = []
        for i in range(nchunks):
            key = "%s/%d" % (prefix, i)
            store.set(key, blob[i * _KV_CHUNK_BYTES : (i + 1) * _KV_CHUNK_BYTES])
            keys.append(key)
        store.set("%s/n" % prefix, str(nchunks))
        keys.append("%s/n" % prefix)
        _kv_keys_set.append((seq, keys, len(blob)))
        _kv_bytes_retained[0] += len(blob)
        min_lag, budget = _kv_gc_limits()
        while _kv_keys_set and (
            _kv_keys_set[0][0] <= seq - _KV_GC_LAG
            or (_kv_bytes_retained[0] > budget and _kv_keys_set[0][0] <= seq - min_lag)
        ):
            _, stale, nbytes = _kv_keys_set.pop(0)
            _kv_bytes_retained[0] -= nbytes
            for key in stale:
                try:
                    store.delete_key(key)
                except RuntimeError:  # GC is best-effort
                    pass
        kv_bytes_retained_peak[0] = max(kv_bytes_retained_peak[0], _kv_bytes_retained[0])
        return payload
    if timeout_secs is None:
        timeout_secs = collective_timeout_secs()
    if timeout_secs is None:
        # Deadline disabled (ADANET_COLLECTIVE_TIMEOUT_SECS=0): the store
        # still needs a bound; a week is "no deadline" in practice.
        timeout_secs = 7 * 24 * 3600.0
    try:
        store.wait(["%s/n" % prefix], datetime.timedelta(seconds=timeout_secs))
        if not want:
            return None
        nchunks = int(store.get("%s/n" % prefix))
        blob = b"".join(bytes(store.get("%s/%d" % (prefix, i))) for i in range(nchunks))
    except RuntimeError as exc:  # the store's timeout, or a dead server
        raise PeerLostError(
            label, timeout_secs=timeout_secs,
            detail="store broadcast fetch failed (dead source or store): %s" % exc,
        ) from exc
    return decode_tree(template, blob)


#: Process groups of multi-owner candidate groups, by their ranks: every
#: process must create each in the same order, once (`new_group` is
#: collective).
_owner_groups: Dict[Tuple[int, ...], object] = {}


def _owner_group(owners: Sequence[int]):
    """The process group of a candidate group's owners (None for one)."""
    if len(owners) <= 1:
        return None
    key = tuple(owners)
    if key not in _owner_groups:
        _owner_groups[key] = dist.new_group(ranks=list(key))
    return _owner_groups[key]


class MultiHostRoundRobinExecutor(RoundRobinExecutor):
    """RoundRobin candidate parallelism across processes.

    Trains through the in-process executor's methods; only ownership,
    member sync, gather and peer loss know about processes. With one
    process it is the in-process executor.

    `sync_stats` counts the member syncs this process took part in, the
    bytes it sent and received through the store for them, and their
    host seconds.
    """

    is_multihost = True

    def __init__(self, iteration: Iteration, strategy: Optional[RoundRobinStrategy] = None, sync_every: int = 1):
        self._process_index = coordination.process_index()
        self._process_count = coordination.process_count()
        super().__init__(iteration, strategy if strategy is not None else RoundRobinStrategy(), sync_every=sync_every)
        self._synced_losses: Dict[str, torch.Tensor] = {}
        self._last_losses: Dict[str, torch.Tensor] = {}
        # Hang-proofing: every store broadcast is bounded by this deadline.
        # When one expires the source process is declared lost, its
        # groups' candidates are quarantined, and ALL further broadcasts
        # are skipped: the iteration finishes with the survivors' data.
        self._collective_timeout = collective_timeout_secs()
        self._lost_processes: set = set()
        self._dead_groups: set = set()
        self._peer_lost_error: Optional[PeerLostError] = None
        self.sync_stats = {"syncs": 0, "bytes": 0, "secs": 0.0}

    # ------------------------------------------------------------- topology

    def _build_meshes(self) -> None:
        groups, owners = multihost_candidate_groups(
            self._n + 1, self.strategy.devices, self._process_count, self._process_index
        )
        self._groups, self._owners = groups, owners
        process_groups = [_owner_group(o) for o in owners]
        here = _device_key(self.iteration.device)
        for g, devices in enumerate(groups):
            if devices and _device_key(devices[0]) != here:
                raise ValueError(
                    "Candidate group %d on %s, but the iteration trains on %s: a process runs its groups on the "
                    "iteration's device." % (g, devices[0], self.iteration.device)
                )
            if process_groups[g] is not None and g > 0 and self._owns(g):
                self._refuse_batch_norm(self.iteration.subnetwork_specs[g - 1].module, g)
        self._process_groups = process_groups

        def group(g):
            return mesh_lib.DeviceGroup(groups[g] or [self.iteration.device], process_groups[g])

        self._ens_mesh = group(0)
        self._sub_meshes = {spec.name: group(1 + i) for i, spec in enumerate(self.iteration.subnetwork_specs)}

    @staticmethod
    def _refuse_batch_norm(module, g) -> None:
        norms = iteration_lib.batch_norm_layers(module)
        if norms:
            raise ValueError(
                "Candidate group %d spans several processes and trains data-parallel, which computes batch-norm "
                "statistics per process, not over the group's batch (%s); give it one process." % (g, ", ".join(norms))
            )

    def _group_index(self, spec_name: Optional[str]) -> int:
        """Group id: 0 for the ensemble, 1+i for subnetwork i."""
        if spec_name is None:
            return 0
        for i, spec in enumerate(self.iteration.subnetwork_specs):
            if spec.name == spec_name:
                return 1 + i
        raise KeyError(spec_name)

    def _owns(self, group_index: int) -> bool:
        return self._process_index in self._owners[group_index]

    @property
    def owns_ensemble(self) -> bool:
        return self._owns(0)

    def owned_groups(self) -> List[int]:
        return [g for g in range(self._n + 1) if self._owns(g)]

    def _trains(self, name: str) -> bool:
        g = self._group_index(name)
        return self._owns(g) and g not in self._dead_groups

    @contextlib.contextmanager
    def _group_scope(self, name: Optional[str]):
        """A multi-owner group's updates all-reduce over its owners'
        process group (`Iteration._global_means`)."""
        pg = self._process_groups[self._group_index(name)]
        if pg is None:
            yield
            return
        previous = self.iteration.process_group
        self.iteration.process_group = pg
        try:
            yield
        finally:
            self.iteration.process_group = previous

    # ---------------------------------------------------------- peer loss

    @property
    def lost_peers(self) -> set:
        """Process indices declared lost (empty in a healthy run)."""
        return set(self._lost_processes)

    @property
    def peer_lost_error(self) -> Optional[PeerLostError]:
        """The first peer-loss diagnosis (None in a healthy run)."""
        return self._peer_lost_error

    def _on_peer_lost(self, exc: PeerLostError) -> None:
        """Quarantines everything this process can no longer reach and
        disables the broadcasts.

        Survivable when every group spanning a lost process is a
        subnetwork group (its candidates die, survivors continue). NOT
        survivable when the ensemble group spans a lost process: the
        selection state lives there, so this raises (the estimator stops,
        resumable after a restart).
        """
        src = exc.source_process
        if src is None or src in self._lost_processes:
            return
        self._lost_processes.add(src)
        if self._peer_lost_error is None:
            self._peer_lost_error = exc
        coordination.mark_peer_lost()
        _LOG.error("Declared process %d LOST (%s); skipping all further broadcasts, continuing with survivors.",
                   src, exc)
        for g, owners in enumerate(self._owners):
            lost_owner = bool(set(owners) & self._lost_processes)
            if g == 0:
                if lost_owner:
                    raise PeerLostError(
                        "ensemble group", source_process=src,
                        detail="the ensemble group spans a lost process; checkpoint and restart to re-form the "
                        "cluster",
                    ) from exc
                continue
            # With broadcasts disabled, a group this process does not own
            # can never deliver its state again, even if its owner is
            # alive: selecting (let alone freezing) it would persist its
            # initial parameters, so EVERY unreachable group is
            # quarantined, not just the lost owners'.
            if not lost_owner and self._owns(g):
                continue
            self._dead_groups.add(g)
            spec = self.iteration.subnetwork_specs[g - 1]
            if spec.name not in self._dead_subnetworks:
                reason = exc if lost_owner else PeerLostError(
                    "group %d unreachable" % g, source_process=owners[0],
                    detail="broadcasts disabled after peer loss; this group's state cannot reach this process",
                )
                self._mark_subnetwork_dead(spec.name, reason)

    # -------------------------------------------------------------- syncing

    def _broadcast_from_group(self, group_index: int, payload_if_owner, template, receivers,
                              label: str = "broadcast"):
        """A tree from the group's first owner to the processes in
        `receivers` that do not own the group (`_broadcast_tree`); every
        process takes part, the others only wait. `payload_if_owner` (a
        zero-arg callable) is evaluated on owners only; receivers decode
        onto `template`'s devices (a zero-arg callable too). Nothing is
        published when no receiver lacks the data.

        Bounded by the collective deadline (plus a watchdog for a wedged
        store connection): a failed wait declares the source lost and the
        caller gets its own data (owners) or None (others). After any
        peer loss, broadcasts are skipped outright."""
        src = self._owners[group_index][0]
        owner = self._owns(group_index)
        if self._process_count == 1:
            return payload_if_owner()
        payload = payload_if_owner() if owner else None
        if self._lost_processes:
            return payload
        is_source = self._process_index == src
        # An owner that is not the source holds the same data already.
        fetch = self._process_index in receivers and not owner
        publish = bool(set(receivers) - set(self._owners[group_index]))
        template_tree = template() if fetch else None
        try:
            result = call_with_deadline(
                lambda: _broadcast_tree(payload, is_source, template_tree, want=fetch, publish=publish,
                                        timeout_secs=self._collective_timeout, label=label),
                None if self._collective_timeout is None else self._collective_timeout + 10.0,
                label,
                source_process=src,
            )
        except PeerLostError as exc:
            if exc.source_process is None:
                exc.source_process = src
            self._on_peer_lost(exc)
            return payload
        return payload if owner else result

    def _maybe_sync_members(self, state: IterationState) -> None:
        """Member sync across processes: every `sync_every` steps each
        subnetwork group's variables (with its last loss and its
        quarantine flag) go from its first owner to every process, and
        the ensemble group's owners load them into their member copies.
        Every process takes part in every round at the same steps."""
        if self._member_copies is not None and self._host_step - self._last_sync_step < self.sync_every:
            return
        self._last_sync_step = self._host_step
        started = time.perf_counter()
        if self._member_copies is None:
            self._member_copies = {}
            if self.owns_ensemble:
                for name, st in state.subnetworks.items():
                    member = copy.deepcopy(st.module).to(self._ens_mesh.device)
                    self._member_copies[name] = member.requires_grad_(False)
        for i, spec in enumerate(self.iteration.subnetwork_specs):
            g, name = 1 + i, spec.name
            st = state.subnetworks[name]

            def local(st=st, name=name):
                loss = self._last_losses.get(name)
                return {
                    "variables": st.module.state_dict(),
                    "loss": torch.zeros((), dtype=torch.float32) if loss is None else loss.detach().float(),
                    "dead": torch.tensor(1 if name in self._dead_subnetworks else 0, dtype=torch.int32),
                }

            def template(st=st):
                return {"variables": st.module.state_dict(), "loss": torch.zeros(()),
                        "dead": torch.zeros((), dtype=torch.int32)}

            receivers = set(self._owners[0])
            synced = self._broadcast_from_group(g, local, template, receivers, label="member sync %s" % name)
            if synced is None:
                continue
            moved = self._process_count > 1 and not self._lost_processes and (
                not self._owns(g) or (self._process_index == self._owners[g][0] and receivers - set(self._owners[g])))
            if moved:  # bytes this process read from, or wrote to, the store
                self.sync_stats["bytes"] += sum(t.numel() * t.element_size() for t in synced["variables"].values())
            if not self._owns(g):
                self._synced_losses["subnetwork_loss/%s" % name] = synced["loss"]
                if int(synced["dead"]) and name not in self._dead_subnetworks:
                    self._dead_subnetworks[name] = "quarantined by its owning process (synced flag)"
                    _LOG.error("Candidate subnetwork %r quarantined by its owning process.", name)
            if self.owns_ensemble:
                with torch.no_grad():
                    dst = list(self._member_copies[name].state_dict().values())
                    torch._foreach_copy_(dst, [v.to(d.device) for v, d in zip(synced["variables"].values(), dst)])
        self.sync_stats["syncs"] += 1
        self.sync_stats["secs"] += time.perf_counter() - started

    # ---------------------------------------------------------------- train

    def _train_subnetworks(self, state, inputs, extra_inputs, metrics) -> None:
        super()._train_subnetworks(state, inputs, extra_inputs, metrics)
        self._last_losses = {
            key.split("/", 1)[1]: value for key, value in metrics.items() if key.startswith("subnetwork_loss/")
        }

    def train_step(self, state: IterationState, batch, extra_batches=None):
        """One candidate-parallel step on this process's `batch`: the
        owned subnetwork groups' updates, the member sync (every
        `sync_every` steps), then, on the ensemble group's owners, every
        mixture-weight update. `extra_batches` maps subnetwork names to
        their own batches (bagging), as in one process. Returns (state,
        metrics); other processes' subnetwork losses arrive with the
        sync."""
        it = self.iteration
        with full_f32_matmul():
            inputs = it._step_inputs(batch)
            extra_inputs = {name: it._step_inputs(b) for name, b in (extra_batches or {}).items()}
            metrics: Dict[str, torch.Tensor] = {}
            self._train_subnetworks(state, inputs, extra_inputs, metrics)
            self._host_step += 1
            self._maybe_sync_members(state)
            metrics.update(self._synced_losses)
            if self.owns_ensemble:
                self._train_ensembles(state, inputs, metrics)
        state.iteration_step += 1
        return state, metrics

    def train_steps(self, state: IterationState, batches):
        """K steps (`iterations_per_loop`): the owned groups' K updates
        step by step, one member sync, then the ensemble group's K
        updates against those copies (staleness max(sync_every, K))."""
        it = self.iteration
        batches = list(batches)
        with full_f32_matmul():
            inputs = [it._step_inputs(batch) for batch in batches]
            metrics: Dict[str, torch.Tensor] = {}
            for step_inputs in inputs:
                self._train_subnetworks(state, step_inputs, {}, metrics)
            self._host_step += len(batches)
            self._maybe_sync_members(state)
            metrics.update(self._synced_losses)
            if self.owns_ensemble:
                for step_inputs in inputs:
                    self._train_ensembles(state, step_inputs, metrics)
        state.iteration_step += len(batches)
        return state, metrics

    # --------------------------------------------------------------- gather

    def gather(self, state: IterationState) -> IterationState:
        """The full state on the chief: each subnetwork group's training
        state (module, optimizer, step, dead flag) from its first owner,
        and the ensembles' from group 0 (which holds the chief). Every
        process takes part in every broadcast; the others only wait.
        With a lost peer the broadcasts are skipped, and unreachable
        groups are quarantined (`_on_peer_lost`), never selected."""
        if self._process_count == 1:
            return state
        for i, spec in enumerate(self.iteration.subnetwork_specs):
            g, name = 1 + i, spec.name
            st = state.subnetworks[name]

            def local(st=st, name=name):
                snapshot = iteration_lib.subnetwork_snapshot(st)
                snapshot["quarantined"] = torch.tensor(1 if name in self._dead_subnetworks else 0, dtype=torch.int32)
                return snapshot

            def template(st=st):
                return iteration_lib.subnetwork_snapshot(st)

            got = self._broadcast_from_group(g, local, template, {0}, label="gather %s" % name)
            if got is None or self._owns(g) or g in self._dead_groups:
                continue
            iteration_lib.load_subnetwork_snapshot(st, got)
            if int(got["quarantined"]) and name not in self._dead_subnetworks:
                self._dead_subnetworks[name] = "quarantined by its owning process (gather flag)"
        got = self._broadcast_from_group(
            0, lambda: iteration_lib.ensembles_snapshot(state),
            lambda: iteration_lib.ensembles_snapshot(state), {0}, label="gather ensemble",
        )
        if got is not None and not self.owns_ensemble:
            iteration_lib.load_ensembles_snapshot(state, got)
        return state
