"""Device groups: the substrate for candidate placement and data parallelism.

Port of adanet_tpu/distributed/mesh.py. A JAX mesh becomes a
`DeviceGroup`: a list of `torch.device`s and, across processes, a
`torch.distributed` process group.

- Candidate placement: `partition_devices` splits the devices into
  groups, one a candidate group (`candidate_submeshes`); with fewer
  devices than groups the groups share devices, as JAX's do. In one
  process a group trains on its first device, so on one card every
  group is that card.
- Data parallelism: across processes, each process feeds its local
  slice of every global batch (`global_batch`) and the engine
  all-reduces the weighted loss numerators, their denominators and the
  gradients over the group's process group (`core/iteration.py`), where
  the JAX program's XLA inserts the all-reduce. In one process there is
  no data parallelism across devices; JAX's in-process multi-device case
  maps onto processes.
- The collective bookkeeping's guard: `check_collective_lockstep` agrees
  on a digest of every process's next batch through the store
  (`coordination.allgather_host`), so that diverging streams raise on
  every process instead of leaving one waiting in an all-reduce.
"""

from __future__ import annotations

import hashlib
from typing import List, Optional, Sequence

import numpy as np
import torch

from adanet_tpu_torch.distributed import coordination
from adanet_tpu_torch.utils.batches import to_device


class DeviceGroup:
    """Devices that train one piece of the work, and the process group
    that spans them across processes (None in one process)."""

    def __init__(self, devices: Sequence, process_group=None):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("A device group needs at least one device.")
        self.process_group = process_group

    @property
    def device(self) -> torch.device:
        """Where this process runs the group's work: its first device."""
        return self.devices[0]

    def __repr__(self) -> str:
        return "DeviceGroup(%s)" % [str(d) for d in self.devices]


def _default_devices() -> List[torch.device]:
    """The CUDA devices of this process; raises without CUDA."""
    from adanet_tpu_torch._device import resolve_device

    resolve_device("cuda")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def data_parallel_mesh(devices: Optional[Sequence] = None) -> DeviceGroup:
    """The group over all (or the given) devices; across processes it
    spans the default process group, each process holding its local
    devices."""
    devices = list(devices) if devices is not None else _default_devices()
    process_group = torch.distributed.group.WORLD if coordination.process_count() > 1 else None
    return DeviceGroup(devices, process_group)


def partition_devices(devices: Sequence, num_groups: int) -> List[List]:
    """Splits devices into `num_groups` contiguous groups (wrapping if
    there are fewer devices than groups)."""
    devices = list(devices)
    if num_groups <= 0:
        raise ValueError("num_groups must be positive.")
    if len(devices) >= num_groups:
        # np.array_split's groups: the first len % num_groups get one more.
        return [[devices[i] for i in part] for part in np.array_split(np.arange(len(devices)), num_groups)]
    # Fewer devices than groups: groups share devices round-robin.
    return [[devices[i % len(devices)]] for i in range(num_groups)]


def candidate_submeshes(num_groups: int, devices: Optional[Sequence] = None) -> List[DeviceGroup]:
    """One group a candidate group, in one process."""
    devices = list(devices) if devices is not None else _default_devices()
    return [DeviceGroup(group) for group in partition_devices(devices, num_groups)]


def shard_batch(batch, group: DeviceGroup, stacked: bool = False):
    """A (features, labels) batch on the group's device. In one process
    a group trains on one device, so nothing is split; `stacked` (a
    window's [steps, batch, ...] leaves) is accepted for the JAX
    signature."""
    del stacked
    return to_device(batch, group.device)


def replicate_state(state, group: DeviceGroup):
    """A tree of tensors on the group's device."""
    return to_device(state, group.device)


def global_batch(batch, group: DeviceGroup, stacked: bool = False):
    """This process's local slice of a global batch, on its device.

    Every process feeds its own slice; the engine all-reduces the
    weighted loss numerator, the denominator (the row count, or the
    example weights' sum) and the gradients over the group, so that
    slices of different sizes and example weights give the global
    batch's mean and gradient."""
    del stacked
    return to_device(batch, group.device)


def _leaves(tree):
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key])
    elif isinstance(tree, (list, tuple)):
        for item in tree:
            yield from _leaves(item)
    elif tree is not None:
        yield tree


def _structure(tree) -> str:
    if isinstance(tree, dict):
        return "{%s}" % ",".join("%r:%s" % (key, _structure(tree[key])) for key in sorted(tree))
    if isinstance(tree, (list, tuple)):
        return "(%s)" % ",".join(_structure(item) for item in tree)
    return "*" if tree is not None else "None"


def batch_signature(batch) -> str:
    """Structural signature of a batch: its tree and each leaf's dtype
    and shape."""
    parts = [_structure(batch)]
    for leaf in _leaves(batch):
        if torch.is_tensor(leaf):
            dtype, shape = str(leaf.dtype).replace("torch.", ""), tuple(leaf.shape)
        else:
            arr = np.asarray(leaf)
            dtype, shape = str(arr.dtype), arr.shape
        parts.append("%s:%s" % (dtype, tuple(shape)))
    return "|".join(parts)


def check_collective_lockstep(batch, context: str = "collective") -> None:
    """Fails fast, on every process, when the processes' streams for a
    collective pass diverge: each process puts a digest of its next batch
    (`None`: end of stream) into the store and reads everyone's. A
    mismatch would leave some processes waiting in an all-reduce the
    others never enter. One host round trip a batch, bookkeeping only."""
    if coordination.process_count() <= 1:
        return
    sig = "<end-of-stream>" if batch is None else batch_signature(batch)
    digest = hashlib.sha256(sig.encode()).hexdigest()[:16]
    gathered = coordination.allgather_host(digest, label="lockstep/%s" % context)
    if any(g != gathered[0] for g in gathered):
        raise ValueError(
            "%s: per-process input streams diverged: this process's next batch is %s, but other processes "
            "disagree (digests %s). Every process must yield the same number of identically-shaped batches "
            "for collective bookkeeping; a mismatch would deadlock in a collective. Check that eval/report "
            "input_fns are deterministic and yield identical stream structure per process."
            % (context, sig, gathered)
        )


def lockstep_batches(input_fn, steps: Optional[int] = None, collective: bool = False, context: str = "collective"):
    """Yields up to `steps` batches from `input_fn`, agreeing on every
    pull (end of stream included) across processes when `collective`."""
    stream = iter(input_fn())
    count = 0
    while True:
        batch = next(stream, None)
        done = batch is None or (steps is not None and count >= steps)
        if collective:
            check_collective_lockstep(None if done else batch, context=context)
        if done:
            return
        yield batch
        count += 1
