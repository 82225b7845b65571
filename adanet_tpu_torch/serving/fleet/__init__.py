"""Replicated serving plane: N replicas, one front tier, one flip.

Port of adanet_tpu/serving/fleet. The single-process serving chain
(`serving/frontend.py` -> `batcher.py` -> `model_pool.py`) scales out
by replication: lease-pinned store refs make the generation chain
multi-reader, the coordination KV's set-once claims give fleet-wide
agreement, and the frontend's typed watermark snapshot is the
backpressure signal. The pieces:

- `replica` — one serving process on its device: bootstraps its
  generation from the shared chain and store, runs the frontend chain
  and publishes heartbeat watermarks on the KV.
- `balancer` — the front tier (a copy): power-of-two choices over
  depth and latency scores, hysteretic exclusion of shedding and stale
  replicas, deadline-aware retry on another replica.
- `flip_coordinator` — coordinated fleet-wide generation flips: one
  replica canaries, then an all-or-none set-once commit; a replica
  SIGKILLed mid-flip completes at respawn or the fleet rolls back.
- `cascade` — cascaded ensemble inference (a copy).
- `transport` — the co-located wire protocol (a copy: framed numpy
  trees over unix sockets; no pickle).

Operator surface: `python -m adanet_tpu_torch.tools.servectl`
(launch/status/cascade/drain).
"""

from adanet_tpu_torch.serving.fleet.balancer import (
    BalancerConfig,
    FleetBalancer,
)
from adanet_tpu_torch.serving.fleet.cascade import CascadeSpec, calibrate
from adanet_tpu_torch.serving.fleet.flip_coordinator import (
    FlipConfig,
    FlipParticipant,
    bootstrap_generation,
)
from adanet_tpu_torch.serving.fleet.replica import (
    NAMESPACE,
    ReplicaConfig,
    ServingReplica,
    fresh_replica_ids,
    publish_heartbeat,
    read_heartbeats,
)

__all__ = [
    "BalancerConfig",
    "CascadeSpec",
    "FleetBalancer",
    "FlipConfig",
    "FlipParticipant",
    "NAMESPACE",
    "ReplicaConfig",
    "ServingReplica",
    "bootstrap_generation",
    "calibrate",
    "fresh_replica_ids",
    "publish_heartbeat",
    "read_heartbeats",
]
