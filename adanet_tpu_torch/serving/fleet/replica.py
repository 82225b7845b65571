"""A serving replica: one frontend/batcher/pool chain in the fleet.

Port of adanet_tpu/serving/fleet/replica.py. The replica's programs run
on its `device` (default `cuda`; a CUDA request without CUDA raises),
and its `REPLICA DRAINED` line carries the process's kernel launch
counts and its program loads and calls by program file, the only record
of them once the process has exited.

Each replica process bootstraps its generation closure directly from
the shared model dir (and lease-pins it in the shared artifact store
when one is attached), runs the existing single-process serving chain
(`ServingFrontend` -> `Batcher` -> `ModelPool`), and adds the two
fleet behaviors:

- **heartbeats** — every `heartbeat_interval_secs` the replica
  publishes `ServingFrontend.stats()`'s typed watermark snapshot
  (queue depth, wait/exec EWMAs, shedding flag, generation) plus its
  identity on the coordination KV. The balancer routes on these; the
  flip coordinator uses their freshness as the liveness census. The
  publish rides the `serving.replica_heartbeat` fault site: an
  injected failure skips the beat (staleness is the detector), it
  never kills serving.
- **coordinated flips** — the pool runs with `follow=False`; new
  generations flip only through `FlipParticipant`'s fleet-wide
  all-or-none protocol, and a (re)spawning replica adopts
  `bootstrap_generation`'s answer so it always joins at the fleet's
  committed generation.

Requests arrive over the replica's unix socket (`fleet.transport`);
the last few request batches are kept as the flip canary's live
sample window.

Runnable as a module (the unit `adanet_tpu_torch.tools.servectl` and
the chaos tests spawn):

    python -m adanet_tpu_torch.serving.fleet.replica \\
        --fleet-dir /fleet --model-dir /fleet/model --replica-id r0 \\
        [--device cpu]

Host-only module: device work happens inside the batcher's programs.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import logging
import os
import sys
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from adanet_tpu_torch.robustness import faults
from adanet_tpu_torch.serving.fleet import transport
from adanet_tpu_torch.serving.fleet.flip_coordinator import (
    FlipConfig,
    FlipParticipant,
    bootstrap_generation,
)

_LOG = logging.getLogger("adanet_tpu_torch")

#: KV namespace shared by every fleet component.
NAMESPACE = "fleet"

#: Subdirectories of a fleet dir.
KV_SUBDIR = "kv"
STORE_SUBDIR = "store"


def heartbeat_key(namespace: str, replica_id: str) -> str:
    return "%s/hb/%s" % (namespace, replica_id)


def publish_heartbeat(
    kv, namespace: str, replica_id: str, payload: Dict[str, Any]
) -> None:
    """Last-writer-wins heartbeat publication (fault-instrumented)."""
    faults.trip("serving.replica_heartbeat")
    kv.set(
        heartbeat_key(namespace, replica_id),
        json.dumps(payload),
        overwrite=True,
    )


def read_heartbeats(kv, namespace: str) -> Dict[str, Dict[str, Any]]:
    """replica_id -> last published heartbeat payload."""
    prefix = "%s/hb/" % namespace
    out: Dict[str, Dict[str, Any]] = {}
    for key, value in kv.scan(prefix).items():
        try:
            payload = json.loads(
                value.decode() if isinstance(value, bytes) else value
            )
        except (ValueError, AttributeError):
            continue
        out[key[len(prefix) :]] = payload
    return out


def fresh_replica_ids(
    heartbeats: Dict[str, Dict[str, Any]],
    now: float,
    stale_secs: float,
) -> set:
    """Replicas whose last beat is younger than `stale_secs`.

    `now` and the heartbeat `ts` share one epoch — the fleet is
    co-located, so wall clock is the shared clock (the same assumption
    the store's TTL leases already make).
    """
    return {
        replica_id
        for replica_id, payload in heartbeats.items()
        if now - float(payload.get("ts", 0.0)) <= stale_secs
    }


@dataclasses.dataclass
class ReplicaConfig:
    replica_id: str
    fleet_dir: str
    model_dir: str
    socket_path: Optional[str] = None
    heartbeat_interval_secs: float = 0.2
    #: A replica is presumed dead after this many seconds without a
    #: beat — the flip coordinator's required-set boundary.
    heartbeat_stale_secs: float = 2.0
    tick_interval_secs: float = 0.05
    bucket_sizes: tuple = (1, 2, 4, 8)
    cascade: bool = True
    #: Per-row cascade splitting (clear rows answered at level 0, only
    #: the residual re-bucketed to the ensemble); False = legacy
    #: per-batch rule. Ignored when `cascade` is off.
    cascade_split_rows: bool = True
    canary_samples: int = 8

    def resolved_socket(self) -> str:
        return self.socket_path or os.path.join(
            self.fleet_dir, self.replica_id + ".sock"
        )


class ServingReplica:
    """The per-process serving unit: chain + heartbeat + flip roles."""

    def __init__(
        self,
        config: ReplicaConfig,
        device="cuda",
        flip_config: Optional[FlipConfig] = None,
        frontend_config=None,
        clock: Callable[[], float] = time.time,
    ):
        from adanet_tpu_torch.distributed.scheduler import FileKV
        from adanet_tpu_torch.serving import (
            Batcher,
            BatcherConfig,
            FrontendConfig,
            ModelPool,
            PoolConfig,
            ServingFrontend,
        )

        self.config = config
        self._clock = clock
        os.makedirs(config.fleet_dir, exist_ok=True)
        self.kv = FileKV(os.path.join(config.fleet_dir, KV_SUBDIR))
        store_root = os.path.join(config.fleet_dir, STORE_SUBDIR)
        self.store = None
        if os.path.isdir(store_root):
            from adanet_tpu_torch.store import ArtifactStore

            self.store = ArtifactStore(store_root)
        self.pool = ModelPool(
            config.model_dir,
            PoolConfig(follow=False),
            device=device,
            store=self.store,
        )
        self.batcher = Batcher(
            self.pool,
            BatcherConfig(
                bucket_sizes=config.bucket_sizes,
                cascade=config.cascade,
                split_rows=config.cascade_split_rows,
            ),
        )
        self.frontend = ServingFrontend(
            self.batcher,
            frontend_config
            or FrontendConfig(poll_interval_secs=3600.0),
        )
        self._samples: collections.deque = collections.deque(
            maxlen=config.canary_samples
        )
        self.participant = FlipParticipant(
            self.kv,
            NAMESPACE,
            config.replica_id,
            self.pool,
            config.model_dir,
            fresh_replicas=self._fresh_replicas,
            sample_fn=lambda: list(self._samples),
            config=flip_config,
            clock=clock,
            bucket_sizes=config.bucket_sizes,
        )
        self._seq = 0
        self._stopped = threading.Event()
        self._control_thread: Optional[threading.Thread] = None
        self._heartbeat_thread: Optional[threading.Thread] = None
        self._server: Optional[transport.SocketServer] = None

    # ----------------------------------------------------------- liveness

    def _fresh_replicas(self) -> set:
        return fresh_replica_ids(
            read_heartbeats(self.kv, NAMESPACE),
            self._clock(),
            self.config.heartbeat_stale_secs,
        )

    def heartbeat_payload(self) -> Dict[str, Any]:
        payload = dict(self.frontend.stats())
        payload.update(
            replica_id=self.config.replica_id,
            pid=os.getpid(),
            seq=self._seq,
            ts=self._clock(),
            address=self.config.resolved_socket(),
        )
        return payload

    def beat(self) -> None:
        self._seq += 1
        try:
            publish_heartbeat(
                self.kv,
                NAMESPACE,
                self.config.replica_id,
                self.heartbeat_payload(),
            )
        except Exception:
            # A missed beat degrades to "this replica looks stale":
            # the balancer excludes it and the flip census drops it —
            # exactly the failure heartbeats exist to surface. Serving
            # itself must not die over telemetry.
            _LOG.exception("Heartbeat publish failed; beat skipped.")

    # ---------------------------------------------------------- lifecycle

    def start(self) -> "ServingReplica":
        self.frontend.start()
        self._server = transport.SocketServer(
            self.config.resolved_socket(), self._handle
        ).start()
        # Heartbeats get their OWN thread: flip staging (deserialize +
        # compile + smoke in participant.step) takes seconds, and a
        # beat gap that long would read as death — the balancer would
        # exclude the whole fleet during every routine flip, and the
        # leader's freshness census would drop followers that are
        # merely busy staging the very generation being flipped.
        self._heartbeat_thread = threading.Thread(
            target=self._heartbeat_loop,
            name="replica-heartbeat",
            daemon=True,
        )
        self._heartbeat_thread.start()
        self._control_thread = threading.Thread(
            target=self._control_loop,
            name="replica-control",
            daemon=True,
        )
        self._control_thread.start()
        return self

    def _heartbeat_loop(self) -> None:
        while not self._stopped.is_set():
            self.beat()
            self._stopped.wait(self.config.heartbeat_interval_secs)

    def _control_loop(self) -> None:
        while not self._stopped.is_set():
            try:
                self.tick()
            except Exception:
                _LOG.exception("Replica control tick failed; continuing.")
            self._stopped.wait(self.config.tick_interval_secs)

    def tick(self) -> None:
        """One flip-plane tick: bootstrap + coordinated-flip step.

        Heartbeats run on their own thread (`_heartbeat_loop`); a
        manual driver that wants both can call `beat()` alongside.
        """
        if self.pool.active is None:
            self._bootstrap()
        self.participant.step()

    def _bootstrap(self) -> None:
        from adanet_tpu_torch.serving.model_pool import (
            GateError,
            gate_generation,
        )

        entry = bootstrap_generation(
            self.kv, NAMESPACE, self.config.model_dir
        )
        if entry is None:
            return
        _, path = entry
        started = time.perf_counter()
        try:
            record = gate_generation(path, self.pool.device)
        except GateError as exc:
            _LOG.error("Bootstrap gate failed for %s: %s", path, exc)
            return
        _LOG.info(
            "REPLICA BOOTSTRAP %s: generation %d gated in %.3f s.",
            self.config.replica_id,
            record.iteration_number,
            time.perf_counter() - started,
        )
        self.pool.adopt(record, how="bootstrap")

    def drain(self, timeout: float = 30.0) -> bool:
        self._stopped.set()
        drained = self.frontend.drain(timeout=timeout)
        if self._server is not None:
            self._server.stop()
        for thread in (self._control_thread, self._heartbeat_thread):
            if thread is not None:
                thread.join(timeout=5.0)
        self.pool.release_store_lease()
        self.kv.delete(
            heartbeat_key(NAMESPACE, self.config.replica_id)
        )
        return drained

    # ----------------------------------------------------------- requests

    def _handle(self, message: Dict) -> Dict:
        op = message.get("op")
        if op == "serve":
            features = message.get("features")
            self._samples.append(features)
            result = self.frontend.submit(
                features, deadline_secs=message.get("deadline_secs")
            )
            return {
                "status": result.status,
                "outputs": result.outputs,
                "generation": result.generation,
                "retry_after": result.retry_after,
                "error": result.error,
                "cascade_level": result.cascade_level,
                "replica_id": self.config.replica_id,
            }
        if op == "stats":
            return {"status": "ok", "stats": self.heartbeat_payload()}
        if op == "drain":
            self.frontend.request_drain()
            return {"status": "ok"}
        return {"status": "error", "error": "unknown op %r" % (op,)}


# -------------------------------------------------------------- module CLI


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m adanet_tpu_torch.serving.fleet.replica",
        description="Run one serving-fleet replica until SIGTERM.",
    )
    parser.add_argument("--fleet-dir", required=True)
    parser.add_argument("--model-dir", required=True)
    parser.add_argument("--replica-id", required=True)
    parser.add_argument("--socket", default=None)
    parser.add_argument(
        "--buckets", default="1,2,4,8", help="comma-separated bucket sizes"
    )
    parser.add_argument(
        "--no-cascade",
        action="store_true",
        help="always run the full ensemble (alias of --cascade-mode off)",
    )
    parser.add_argument(
        "--cascade-mode",
        choices=("row", "batch", "off"),
        default="row",
        help="row = per-row split (default), batch = legacy "
        "whole-batch fallthrough, off = full ensemble always",
    )
    parser.add_argument(
        "--heartbeat-interval", type=float, default=0.2
    )
    parser.add_argument(
        "--heartbeat-stale", type=float, default=2.0
    )
    parser.add_argument(
        "--device", default="cuda", help="the programs' device (cuda or cpu)"
    )
    args = parser.parse_args(argv)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(message)s",
    )
    replica = ServingReplica(
        ReplicaConfig(
            replica_id=args.replica_id,
            fleet_dir=args.fleet_dir,
            model_dir=args.model_dir,
            socket_path=args.socket,
            bucket_sizes=tuple(
                int(b) for b in args.buckets.split(",") if b
            ),
            cascade=not args.no_cascade and args.cascade_mode != "off",
            cascade_split_rows=args.cascade_mode == "row",
            heartbeat_interval_secs=args.heartbeat_interval,
            heartbeat_stale_secs=args.heartbeat_stale,
        ),
        device=args.device,
    )
    replica.start()
    replica.frontend.install_sigterm_handler()
    print("REPLICA READY %s" % replica.config.replica_id, flush=True)
    # Serve until a SIGTERM drains the frontend; the drained event is
    # the exit signal (the frontend stops admitting, answers the
    # queue, then sets it).
    while not replica.frontend._drained.wait(0.5):
        pass
    replica.drain(timeout=30.0)
    print(
        "REPLICA DRAINED %s %s"
        % (replica.config.replica_id, json.dumps(drained_counts(), sort_keys=True)),
        flush=True,
    )
    return 0


def drained_counts() -> Dict[str, Any]:
    """This process's kernel launches (`ops.launch_counts()`) and its
    program loads and calls by program file (`export.program_counts()`),
    as the `REPLICA DRAINED` line prints them."""
    import torch

    from adanet_tpu_torch import ops
    from adanet_tpu_torch.core import export

    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    return dict(launches=ops.launch_counts(), **export.program_counts())


if __name__ == "__main__":
    sys.exit(main())
