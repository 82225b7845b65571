"""Distributed execution of the port: device groups (`mesh.py`),
placement strategies (`placement.py`), the in-process RoundRobin
executor (`executor.py`), RoundRobin across processes (`multihost.py`),
process roles and the chief/worker handshake (`coordination.py`), and
the lease-based work queue: its stores, its tree codec, the callable
drain behind ModelFlow's `ParallelScheduler` and the elastic executor
(`scheduler.py`)."""

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
from adanet_tpu_torch.distributed.multihost import (  # noqa: F401
    MultiHostRoundRobinExecutor,
    multihost_candidate_groups,
)
from adanet_tpu_torch.distributed.placement import (  # noqa: F401
    ElasticWorkQueueStrategy,
    PlacementStrategy,
    ReplicationStrategy,
    RoundRobinStrategy,
)
from adanet_tpu_torch.distributed.scheduler import (  # noqa: F401
    CoordinationKV,
    ElasticRunResult,
    ElasticWorkQueueExecutor,
    FileKV,
    InMemoryKV,
    LeaseLostError,
    LeaseRenewer,
    WorkQueue,
    WorkQueueConfig,
    WorkUnit,
    coordination_kv,
    decode_tree,
    drain_callables,
    encode_tree,
    plan_windows,
)
