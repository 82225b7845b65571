"""Placement strategies: which devices train which candidates.

Port of adanet_tpu/distributed/placement.py (its `PlacementStrategy`,
`ReplicationStrategy` and `RoundRobinStrategy`, with the same method
names; a "mesh" is a `mesh.DeviceGroup`):

- `ReplicationStrategy`: every candidate trains in the one fused step
  (`Iteration.train_step`), and across processes data-parallel.
- `RoundRobinStrategy`: the devices are partitioned into
  `num_subnetworks + 1` groups: group 0 trains the ensembles (mixture
  weights), group i + 1 trains subnetwork i (the reference's worker-modulo
  placement). With fewer devices than groups the groups wrap around and
  share devices, so on one card every group is that card.
  `executor.RoundRobinExecutor` runs it in one process, and
  `multihost.MultiHostRoundRobinExecutor` across processes.
- `ElasticWorkQueueStrategy`: units of a candidate's (or the ensemble's)
  window of steps are pulled from a lease-based work queue
  (`scheduler.ElasticWorkQueueExecutor`), in one process or several.
"""

from __future__ import annotations

import abc
import dataclasses
from typing import Any, Callable, List, Optional, Sequence

from adanet_tpu_torch.distributed import mesh as mesh_lib


class PlacementStrategy(abc.ABC):
    """Abstract placement strategy (reference: placement.py:30-100)."""

    @abc.abstractmethod
    def should_build_ensemble(self, num_subnetworks: int) -> bool:
        """Whether this task's steps include ensemble (mixture-weight) training."""

    @abc.abstractmethod
    def should_build_subnetwork(self, num_subnetworks: int, subnetwork_index: int) -> bool:
        """Whether this task's steps include the given subnetwork's forward."""

    @abc.abstractmethod
    def should_train_subnetworks(self, num_subnetworks: int) -> bool:
        """Whether this task trains the subnetworks it builds."""

    @abc.abstractmethod
    def subnetwork_mesh(self, num_subnetworks: int, subnetwork_index: int) -> mesh_lib.DeviceGroup:
        """The group the given subnetwork trains on."""

    @abc.abstractmethod
    def ensemble_mesh(self, num_subnetworks: int) -> mesh_lib.DeviceGroup:
        """The group ensembles (mixture weights) train on."""


class ReplicationStrategy(PlacementStrategy):
    """Every candidate on the full group (reference: placement.py:103-131)."""

    def __init__(self, mesh: Optional[mesh_lib.DeviceGroup] = None):
        self._mesh = mesh

    @property
    def mesh(self) -> mesh_lib.DeviceGroup:
        if self._mesh is None:
            self._mesh = mesh_lib.data_parallel_mesh()
        return self._mesh

    def should_build_ensemble(self, num_subnetworks):
        return True

    def should_build_subnetwork(self, num_subnetworks, subnetwork_index):
        return True

    def should_train_subnetworks(self, num_subnetworks):
        return True

    def subnetwork_mesh(self, num_subnetworks, subnetwork_index):
        return self.mesh

    def ensemble_mesh(self, num_subnetworks):
        return self.mesh


class RoundRobinStrategy(PlacementStrategy):
    """Disjoint device groups a candidate group (reference:
    placement.py:134-320). Group 0 owns ensembles; group i + 1 owns
    subnetwork i; with fewer devices than groups, groups share devices.

    Args:
      devices: devices to partition; by default this process's CUDA
        devices (a CUDA request without CUDA raises). Pass
        `[torch.device("cpu")]` to place on the CPU.
    """

    def __init__(self, devices: Optional[Sequence] = None):
        self._devices = list(devices) if devices is not None else mesh_lib._default_devices()

    @property
    def devices(self) -> List:
        return list(self._devices)

    def _groups(self, num_subnetworks: int) -> List[List]:
        return mesh_lib.partition_devices(self._devices, num_subnetworks + 1)

    def should_build_ensemble(self, num_subnetworks):
        return True

    def should_build_subnetwork(self, num_subnetworks, subnetwork_index):
        return True

    def should_train_subnetworks(self, num_subnetworks):
        return True

    def subnetwork_mesh(self, num_subnetworks, subnetwork_index):
        groups = self._groups(num_subnetworks)
        return mesh_lib.DeviceGroup(groups[1 + (subnetwork_index % num_subnetworks)])

    def ensemble_mesh(self, num_subnetworks):
        return mesh_lib.DeviceGroup(self._groups(num_subnetworks)[0])


@dataclasses.dataclass
class ElasticWorkQueueStrategy(PlacementStrategy):
    """Pull-based elastic placement: a process claims work units under
    TTL leases instead of owning a candidate for the whole round
    (`scheduler.ElasticWorkQueueExecutor`; reference: the JAX package's
    placement.py:134-201, with the same fields).

    A unit runs on one device, this process's unit device (the first of
    `devices`), which must be the iteration's: a unit's numbers then
    depend on nothing but its inputs, so one process, two, and a world
    that shrank and grew back train the same trajectory. The JAX
    package's `unit_devices` sizes a unit's submesh; a unit across
    several cards is not ported, so `unit_devices` > 1 raises.

    Args:
      window_steps: training steps a work unit (the re-issue and
        member-staleness granule; the `iterations_per_loop` analogue).
      lease_ttl_secs: lease TTL; a worker silent for this long is
        presumed dead and its unit re-issues (`ADANET_LEASE_TTL_SECS`).
      max_attempts: re-issues a unit before its candidate is poisoned
        into the `CandidateState.dead` quarantine.
      unit_devices: devices a unit (None or 1).
      speculate_steps: when > 0, the chief pre-trains this many steps of
        iteration t+1's candidates against the likely winner once t
        drains; the warm states are dropped if the selected winner flips.
      poll_interval_secs / drain_timeout_secs: the drain's poll period
        and its stall deadline (`ADANET_DRAIN_TIMEOUT_SECS`).
      kv / clock: an injectable store and clock for deterministic tests.
      devices: this process's devices; by default its CUDA devices (a
        CUDA request without CUDA raises). Pass `[torch.device("cpu")]`
        to place on the CPU.
    """

    window_steps: int = 4
    lease_ttl_secs: Optional[float] = None
    max_attempts: int = 3
    unit_devices: Optional[int] = None
    speculate_steps: int = 0
    poll_interval_secs: float = 0.05
    drain_timeout_secs: Optional[float] = None
    kv: Optional[Any] = None
    clock: Optional[Callable[[], float]] = None
    devices: Optional[Sequence] = None

    def __post_init__(self):
        if self.unit_devices is not None and int(self.unit_devices) > 1:
            raise ValueError(
                "unit_devices=%d: a work unit across several devices is not ported; a unit runs on one device."
                % self.unit_devices
            )
        self.devices = list(self.devices) if self.devices is not None else mesh_lib._default_devices()

    def queue_config(self):
        from adanet_tpu_torch.distributed.scheduler import WorkQueueConfig

        config = WorkQueueConfig(
            window_steps=self.window_steps,
            max_attempts=self.max_attempts,
            poll_interval_secs=self.poll_interval_secs,
        )
        if self.lease_ttl_secs is not None:
            config.lease_ttl_secs = float(self.lease_ttl_secs)
        if self.drain_timeout_secs is not None:
            config.drain_timeout_secs = float(self.drain_timeout_secs)
        return config

    def _unit_mesh(self) -> mesh_lib.DeviceGroup:
        return mesh_lib.DeviceGroup(self.devices[:1])

    def should_build_ensemble(self, num_subnetworks):
        return True

    def should_build_subnetwork(self, num_subnetworks, subnetwork_index):
        return True

    def should_train_subnetworks(self, num_subnetworks):
        return True

    def subnetwork_mesh(self, num_subnetworks, subnetwork_index):
        return self._unit_mesh()

    def ensemble_mesh(self, num_subnetworks):
        return self._unit_mesh()
