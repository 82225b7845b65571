"""Process roles, the process group and the chief/worker handshake.

Port of adanet_tpu/distributed/coordination.py. `initialize` joins a
`torch.distributed` process group (the counterpart of
`jax.distributed.initialize`), given its address, world size and rank
by the caller: nothing on the machine tells a program of a cluster.

The backend follows one stated rule, never a fallback: what the caller
passes, else "nccl" when the process trains on the card and "gloo" on
the CPU. NCCL refuses two ranks on one card, so two processes sharing a
card pass `backend="gloo"`; gloo reduces CUDA tensors too (its
`all_reduce` and `broadcast`, which is all the data path uses).

Host flags (the stop agreement, the collective bookkeeping's lockstep
guard) go through the process group's store, the counterpart of the JAX
coordination service's key-value store, never through a device
collective: a store wait has a deadline, so a dead peer raises
`PeerLostError` where a collective would wedge the survivor.

The filesystem half is the JAX package's: workers never run the
bookkeeping phase; they poll the checkpoint manifest until the chief
advances the iteration (`wait_for_iteration`), with a countdown after
which they give up (`WorkerWaitTimeout`), and a stale chief heartbeat
(`robustness.watchdog.HeartbeatWriter`) raises `PeerLostError` sooner.

The store lives in the chief's process, so `leave` ends a process group
together (workers flag, the chief waits for the flags), and `shutdown`
never hangs: after a peer loss (`mark_peer_lost`) it drops the group
without its teardown, otherwise it bounds the teardown.
"""

from __future__ import annotations

import datetime
import logging
import threading
import time
from typing import List, Optional

import torch
import torch.distributed as dist

from adanet_tpu_torch._device import resolve_device
from adanet_tpu_torch.core import checkpoint as ckpt_lib
from adanet_tpu_torch.core.timer import CountDownTimer
from adanet_tpu_torch.robustness import watchdog

_LOG = logging.getLogger("adanet_tpu_torch")


def backend_for(device, backend: Optional[str] = None) -> str:
    """The process group's backend: `backend` when given, else "nccl" for
    a CUDA device and "gloo" for the CPU."""
    if backend is not None:
        return backend
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device="cuda",
    backend: Optional[str] = None,
) -> torch.device:
    """Joins the process group of `num_processes` processes as rank
    `process_id`, its store at `coordinator_address` ("host:port", the
    chief's). Returns the device this process trains on (a CUDA request
    without CUDA raises). A no-op for one process."""
    device = resolve_device(device)
    if num_processes is None or num_processes <= 1:
        return device
    if coordinator_address is None or process_id is None:
        raise ValueError("initialize needs coordinator_address and process_id for %d processes." % num_processes)
    if device.type == "cuda" and device.index is not None:
        torch.cuda.set_device(device)
    timeout = watchdog.collective_timeout_secs()
    dist.init_process_group(
        backend=backend_for(device, backend),
        init_method="tcp://%s" % coordinator_address,
        world_size=int(num_processes),
        rank=int(process_id),
        timeout=datetime.timedelta(seconds=timeout if timeout is not None else 7 * 24 * 3600),
    )
    return device


_peer_lost = [False]


def mark_peer_lost() -> None:
    """Records that a peer of this process was declared lost: `shutdown`
    then leaves the process group without tearing it down."""
    _peer_lost[0] = True


def shutdown(timeout_secs: float = 30.0) -> None:
    """Leaves the process group, if this process joined one, and never
    hangs: after a peer loss (`mark_peer_lost`) the group is dropped
    without its teardown, whose handshakes a dead peer could block;
    otherwise the teardown runs on a daemon thread bounded by
    `timeout_secs`, after which it is abandoned with a warning."""
    if not (dist.is_available() and dist.is_initialized()):
        return
    if _peer_lost[0]:
        _LOG.warning("Leaving the process group without its teardown: a peer was lost.")
        return
    done = threading.Event()

    def teardown():
        try:
            dist.destroy_process_group()
        finally:
            done.set()

    threading.Thread(target=teardown, name="process-group-teardown", daemon=True).start()
    if not done.wait(timeout_secs):
        _LOG.warning("The process group's teardown did not finish within %.0fs; abandoned.", timeout_secs)


def leave(timeout_secs: float = 60.0) -> None:
    """Leaves the process group together. The store lives in the chief's
    process, so a worker's last store operation must not meet a chief
    that already left: each worker flags through the store that it is
    leaving and goes; the chief waits for every flag, bounded by
    `timeout_secs` (a dead worker never flags), then goes. Then
    `shutdown`."""
    world = process_count()
    if world > 1:
        store = dist.distributed_c10d._get_default_store()
        rank = dist.get_rank()
        if rank != 0:
            store.set("adanet_leave/%d" % rank, "1")
        else:
            try:
                store.wait(["adanet_leave/%d" % r for r in range(1, world)], datetime.timedelta(seconds=timeout_secs))
            except RuntimeError as exc:
                _LOG.warning("Leaving without every worker's flag within %.0fs: %s", timeout_secs, exc)
    shutdown()


_process_index_override: Optional[int] = None


def set_process_index_for_testing(index: Optional[int]) -> None:
    """Explicit role override for the multi-process test harness (an
    in-process setter, not an env var, so that stray environment state
    can never fork two chiefs or leave a run chiefless)."""
    global _process_index_override
    _process_index_override = index


def process_count() -> int:
    """Processes in the process group (1 without one)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def process_index() -> int:
    if _process_index_override is not None:
        return _process_index_override
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def is_chief() -> bool:
    """Process 0 runs bookkeeping (selection, reports, checkpoints)."""
    return process_index() == 0


# Rounds of each label's store agreement, in this process; every process
# runs the same agreements in the same order, so the rounds line up.
_rounds: dict = {}


def allgather_host(value: str, label: str = "flag", timeout_secs: Optional[float] = None) -> List[str]:
    """Every process's `value` for this round of `label`, by rank, through
    the process group's store (a host round trip, no device collective).
    A peer that does not answer within `timeout_secs` (the collective
    deadline by default) raises `PeerLostError`."""
    world = process_count()
    if world <= 1:
        return [value]
    store = dist.distributed_c10d._get_default_store()
    rank = dist.get_rank()
    round_ = _rounds.get(label, 0) + 1
    _rounds[label] = round_
    prefix = "adanet_host/%s/%d/" % (label, round_)
    store.set(prefix + str(rank), value)
    keys = [prefix + str(r) for r in range(world)]
    timeout = watchdog.collective_timeout_secs() if timeout_secs is None else timeout_secs
    try:
        store.wait(keys, datetime.timedelta(seconds=timeout if timeout is not None else 7 * 24 * 3600))
        values = [store.get(key).decode() for key in keys]
    except RuntimeError as exc:  # the store's timeout or a dead server
        raise watchdog.PeerLostError(label, timeout_secs=timeout, detail=str(exc)) from exc
    if round_ > 2:
        # Every process has read round - 2 before it wrote round - 1.
        store.delete_key("adanet_host/%s/%d/%d" % (label, round_ - 2, rank))
    return values


def allgather_host_flag(value: int, label: str = "flag") -> List[int]:
    """`allgather_host` of an integer flag."""
    return [int(v) for v in allgather_host(str(int(value)), label)]


class WorkerWaitTimeout(TimeoutError):
    """The chief did not advance the iteration within the timeout."""


def wait_for_iteration(
    model_dir: str,
    iteration_number: int,
    timeout_secs: float = 7200.0,
    poll_interval_secs: float = 1.0,
    heartbeat_timeout_secs: Optional[float] = None,
) -> ckpt_lib.CheckpointInfo:
    """Blocks until the manifest reaches `iteration_number` and returns
    it. Raises `WorkerWaitTimeout` after `timeout_secs`. Once a chief
    heartbeat has been seen, a staleness beyond `heartbeat_timeout_secs`
    raises `PeerLostError` instead (a dead chief, not a slow one); dirs
    without a heartbeat keep the plain countdown.

    Only a manifest the chief wrote counts, read without quarantining
    (the chief alone mutates the dir): its bookkeeping lands the
    architecture file, then the frozen payload, then the manifest, so an
    iteration reconstructed from the architecture chain may still lack
    its payload."""
    timer = CountDownTimer(timeout_secs)
    while True:
        info = ckpt_lib.read_manifest(model_dir, quarantine=False, reconstruct=False)
        if info is not None and info.iteration_number >= iteration_number:
            return info
        if timer.secs_remaining() <= 0:
            raise WorkerWaitTimeout(
                "Gave up waiting for the chief to write iteration %d to %s after %.0fs."
                % (iteration_number, model_dir, timeout_secs)
            )
        if heartbeat_timeout_secs is not None:
            age = watchdog.heartbeat_age(model_dir, "chief")
            if age is not None and age > heartbeat_timeout_secs:
                raise watchdog.PeerLostError(
                    "chief heartbeat",
                    timeout_secs=heartbeat_timeout_secs,
                    source_process=0,
                    detail="heartbeat stale for %.1fs while waiting for iteration %d in %s"
                    % (age, iteration_number, model_dir),
                )
        _LOG.debug(
            "Waiting for chief to finish iteration %d (%.0fs remaining)",
            iteration_number - 1,
            timer.secs_remaining(),
        )
        time.sleep(poll_interval_secs)
