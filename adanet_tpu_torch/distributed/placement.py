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
  `executor.RoundRobinExecutor` runs it in one process.
"""

from __future__ import annotations

import abc
from typing import List, Optional, Sequence

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
