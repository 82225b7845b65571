"""Distributed execution of the port: device groups (`mesh.py`),
placement strategies (`placement.py`), the in-process RoundRobin
executor (`executor.py`), process roles and the chief/worker handshake
(`coordination.py`), and the lease-based work queue and callable drain
behind ModelFlow's `ParallelScheduler` (`scheduler.py`). The multi-host
RoundRobin executor and the elastic work queue are not ported yet."""

from adanet_tpu_torch.distributed.coordination import (  # noqa: F401
    WorkerWaitTimeout,
    initialize,
    is_chief,
    process_count,
    process_index,
    set_process_index_for_testing,
    wait_for_iteration,
)
from adanet_tpu_torch.distributed.executor import CANDIDATE_FAULTS, RoundRobinExecutor  # noqa: F401
from adanet_tpu_torch.distributed.mesh import (  # noqa: F401
    DeviceGroup,
    batch_signature,
    candidate_submeshes,
    check_collective_lockstep,
    data_parallel_mesh,
    global_batch,
    lockstep_batches,
    partition_devices,
    replicate_state,
    shard_batch,
)
from adanet_tpu_torch.distributed.placement import (  # noqa: F401
    PlacementStrategy,
    ReplicationStrategy,
    RoundRobinStrategy,
)
from adanet_tpu_torch.distributed.scheduler import (  # noqa: F401
    InMemoryKV,
    LeaseLostError,
    LeaseRenewer,
    WorkQueue,
    WorkQueueConfig,
    WorkUnit,
    drain_callables,
    plan_windows,
)
