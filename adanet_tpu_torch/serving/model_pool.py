"""Health-gated generation flips: serve the frozen t-1 winner while t trains.

Port of adanet_tpu/serving/model_pool.py. A `ModelPool` follows the
generation chain (`<model_dir>/serving/gen-<t>/`, written by
`serving.publisher`) and swaps the served program under live traffic.
Every flip is gated:

1. **verify-on-load**: `robustness.integrity.verify_serving_generation`
   checks every artifact against its SHA-256 digest and the manifest's
   required self-checksum; bit rot or a torn publish is rejected before
   a byte is deserialized.
2. **load + smoke**: the generation's hermetic program (`serving.pt2`)
   is loaded onto the pool's device (`core.export.load_serving_program`,
   which on the card first runs the kernels' self-test) and executed once
   on a zeros sample built from the exported signature; so is the
   cascade's cheap program (`cascade.pt2`) when the signature has a
   cascade record, whose outputs must have the full program's structure.
   A load failure, non-finite outputs or an incongruent cascade reject
   the generation.
3. **canary**: with an incumbent serving, a generation that passed 1-2
   is staged as the canary. The batcher replays every executed batch on
   it and reports its health (executed cleanly, finite outputs, and,
   with `PoolConfig.max_divergence`, a bounded divergence from the
   incumbent). After `canary_requests` healthy batches it becomes the
   incumbent by an atomic reference swap, so every request is answered
   by exactly one complete generation. The first generation (no
   incumbent) is promoted by 1-2 alone.

A failure at any gate is a rollback: the incumbent keeps serving, the
rejected directory is quarantined (renamed `gen-<t>.corrupt`, `.1`, `.2`
... on a clash) and never retried, and the decision is logged. A fresh
publish of iteration t lands in a new `gen-<t>`, which is tried.

With an artifact store (`store=`), every promoted generation's ref
closure is pinned under this pool's TTL lease, so that a GC pass on the
shared store never reclaims blobs the live pool may need; a failing store
never stops serving.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from adanet_tpu_torch._device import resolve_device
from adanet_tpu_torch.core import checkpoint as ckpt
from adanet_tpu_torch.robustness import faults, integrity
from adanet_tpu_torch.serving import publisher

_LOG = logging.getLogger("adanet_tpu_torch")

#: A rejected generation directory is renamed with the checkpoint
#: layer's quarantine suffix: one convention for every quarantined
#: artifact in a model dir.
QUARANTINE_SUFFIX = ckpt.QUARANTINE_SUFFIX

PROGRAM_FILE = integrity.REQUIRED_SERVING_FILES[0]


class NoServableGeneration(RuntimeError):
    """No generation has passed the health gate yet."""


class GateError(RuntimeError):
    """A generation failed the verify/load/smoke gate."""


@dataclasses.dataclass
class PoolConfig:
    """Flip-gate policy.

    `canary_requests` healthy mirrored batches promote a candidate; more
    than `max_canary_failures` unhealthy ones roll it back.
    `max_divergence` (optional) also bounds the max absolute difference
    between candidate and incumbent outputs on mirrored traffic: off by
    default, because consecutive AdaNet generations differ by design (the
    new one has one more member); set it for replicas serving the same
    generation chain. `quarantine` renames rejected directories.
    `follow=False` makes `poll()` a no-op: an external flip plane (the
    serving fleet's `FlipParticipant`) gates generations itself and
    installs them with `ModelPool.adopt`.
    """

    canary_requests: int = 8
    max_canary_failures: int = 0
    max_divergence: Optional[float] = None
    quarantine: bool = True
    follow: bool = True


@dataclasses.dataclass
class GenerationRecord:
    """One loaded, servable generation."""

    iteration_number: int
    path: str
    program: Callable
    signature: Dict[str, Any]
    #: The cascade's level-0 program and its calibration record
    #: (`serving.fleet.cascade`), when the generation published one.
    cascade_program: Optional[Callable] = None
    cascade: Optional[Dict[str, Any]] = None


def _build_sample(tree, batch: int = 1):
    """Zeros features matching the exported input signature (symbolic
    dims become `batch`)."""
    if isinstance(tree, dict) and set(tree) == {"shape", "dtype"}:
        shape = tuple(int(d) if str(d).isdigit() else batch for d in tree["shape"])
        return np.zeros(shape, np.dtype(tree["dtype"]))
    if isinstance(tree, dict):
        return {k: _build_sample(v, batch) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_build_sample(v, batch) for v in tree)
    raise ValueError("Unrecognized signature node: %r" % (tree,))


def to_host(outputs):
    """An output tree with every tensor copied to host numpy."""
    if isinstance(outputs, dict):
        return {k: to_host(v) for k, v in outputs.items()}
    if isinstance(outputs, (list, tuple)):
        return type(outputs)(to_host(v) for v in outputs)
    if torch.is_tensor(outputs):
        return outputs.detach().cpu().numpy()
    return np.asarray(outputs)


def outputs_finite(outputs) -> bool:
    """True iff every float leaf of an output tree is fully finite."""
    stack = [to_host(outputs)]
    while stack:
        node = stack.pop()
        if isinstance(node, dict):
            stack.extend(node.values())
        elif isinstance(node, (list, tuple)):
            stack.extend(node)
        else:
            arr = np.asarray(node)
            if np.issubdtype(arr.dtype, np.floating) and not np.all(np.isfinite(arr)):
                return False
    return True


def gate_generation(path: str, device) -> GenerationRecord:
    """Verify + load + smoke one published generation; returns the
    servable record or raises `GateError`."""
    from adanet_tpu_torch.core import export as export_lib

    issues = integrity.verify_serving_generation(path)
    if issues:
        raise GateError("verification failed: %s" % issues)
    with open(os.path.join(path, integrity.GENERATION_MANIFEST)) as f:
        t = int(json.load(f)["iteration_number"])
    from adanet_tpu_torch.serving.fleet import cascade as cascade_lib

    try:
        faults.trip("serving.model_load")
        program = export_lib.load_serving_program(path, device=device)
        signature = export_lib.serving_signature(path)
        cascade = signature.get(cascade_lib.SIGNATURE_KEY)
        cascade_program = None
        if cascade is not None:
            cascade_program = export_lib.load_serving_program(
                path, cascade.get("program", export_lib.CASCADE_FILE), device=device
            )
    except Exception as exc:
        raise GateError("load failed: %s: %s" % (type(exc).__name__, exc)) from exc
    try:
        sample = _build_sample(signature.get("inputs", {}))
        outputs = program(sample)
        if not outputs_finite(outputs):
            raise ValueError("non-finite outputs on the smoke sample")
        if cascade_program is not None:
            cheap = cascade_program(sample)
            if not outputs_finite(cheap):
                raise ValueError("non-finite cascade outputs on the smoke sample")
            if _structure(cheap) != _structure(outputs):
                raise ValueError("cascade outputs %s are not congruent with the program's %s"
                                 % (_structure(cheap), _structure(outputs)))
    except Exception as exc:
        raise GateError("smoke execution failed: %s: %s" % (type(exc).__name__, exc)) from exc
    return GenerationRecord(t, path, program, signature, cascade_program, cascade)


def _structure(outputs):
    """The keys and per-row shapes of an output tree."""
    if isinstance(outputs, dict):
        return {key: _structure(value) for key, value in outputs.items()}
    return tuple(outputs.shape[1:])


class ModelPool:
    """Follows the generation chain; owns the incumbent and the canary.

    Thread contract: `poll()` runs on one poller thread; `active_record`,
    `canary_record` and `report_canary` are called by the batcher's
    executor thread. State transitions happen under one lock; the flip
    itself is a reference swap, so a batch captures its generation once.
    """

    def __init__(
        self,
        model_dir: str,
        config: Optional[PoolConfig] = None,
        device="cuda",
        store=None,
        store_lease_ttl_secs: float = 3600.0,
    ):
        self._model_dir = model_dir
        self.config = config or PoolConfig()
        self.device = resolve_device(device)
        self._clock: Callable[[], float] = time.monotonic
        # The shared artifact store: each promoted generation's closure is
        # pinned under one TTL lease of this pool.
        self._store = store
        self._store_lease = None
        self._store_lease_ttl = float(store_lease_ttl_secs)
        self._lock = threading.Lock()
        self._active: Optional[GenerationRecord] = None
        self._canary: Optional[GenerationRecord] = None
        self._canary_healthy = 0
        self._canary_failures = 0
        # Directory identities a flip was attempted for: a rejected
        # generation is not retried, but a fresh publish of the same
        # iteration number (a new directory) is.
        self._attempted = set()
        self.flips = 0
        self.rollbacks = 0
        self.events: List[Dict[str, Any]] = []
        from adanet_tpu_torch.observability import flightrec
        from adanet_tpu_torch.observability import metrics as metrics_lib

        reg = metrics_lib.registry()
        self._m_flips = reg.counter("serving.pool.flips")
        self._m_rollbacks = reg.counter("serving.pool.rollbacks")
        self._m_rejects = reg.counter("serving.pool.rejects")
        flightrec.install_default(os.path.join(model_dir, flightrec.DEFAULT_SUBDIR))

    # ------------------------------------------------------------ accessors

    @property
    def active(self) -> Optional[GenerationRecord]:
        with self._lock:
            return self._active

    def active_record(self) -> GenerationRecord:
        with self._lock:
            if self._active is None:
                raise NoServableGeneration("no generation has passed the health gate yet")
            return self._active

    def canary_record(self) -> Optional[GenerationRecord]:
        with self._lock:
            return self._canary

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "active_generation": self._active.iteration_number if self._active else None,
                "canary_generation": self._canary.iteration_number if self._canary else None,
                "flips": self.flips,
                "rollbacks": self.rollbacks,
            }

    # ----------------------------------------------------------------- poll

    def poll(self) -> bool:
        """One discovery pass; returns True when a flip was attempted.

        Skips straight to the newest unattempted generation (the rule
        `integrity.serving_report` audits as `selected_generation`). At
        most one flip is in flight: a staged canary resolves first. An
        externally driven pool (`follow=False`) never flips here.
        """
        if not self.config.follow:
            return False
        with self._lock:
            if self._canary is not None:
                return False
            active = self._active
        candidates = []
        for t, path in publisher.list_generations(self._model_dir):
            if active is not None and t <= active.iteration_number:
                continue
            identity = self._identity(path)
            if identity is None or identity in self._attempted:
                continue
            candidates.append((t, path, identity))
        if not candidates:
            return False
        t, path, identity = candidates[-1]
        self._attempted.add(identity)
        self._begin_flip(t, path)
        return True

    @staticmethod
    def _identity(path: str):
        try:
            st = os.stat(path)
        except OSError:
            return None
        return (st.st_ino, st.st_mtime_ns)

    # ------------------------------------------------------------ flip gate

    def _begin_flip(self, t: int, path: str) -> None:
        program_path = os.path.join(path, PROGRAM_FILE)
        try:
            with open(program_path, "rb") as f:
                program_bytes = f.read()
        except OSError as exc:
            self._reject(t, path, "program unreadable: %s" % exc)
            return
        # The chaos seam: `rot` flips bits of the program on disk here,
        # after publication and before verification, which must catch it.
        # A raising mode is a flip failure like any other: escaping the
        # gate would leave the generation attempted but never
        # quarantined, with no event logged.
        try:
            faults.trip("serving.flip", path=program_path, data=program_bytes)
        except Exception as exc:
            self._reject(t, path, "flip interrupted: %s: %s" % (type(exc).__name__, exc))
            return
        try:
            record = gate_generation(path, self.device)
        except GateError as exc:
            self._reject(t, path, str(exc))
            return
        promoted = None
        with self._lock:
            if self._active is None:
                # Bootstrap: no incumbent to canary against; verify, load
                # and smoke are the whole gate.
                self._promote_locked(record, how="bootstrap")
                promoted = record
            else:
                self._canary = record
                self._canary_healthy = 0
                self._canary_failures = 0
        if promoted is not None:
            self._pin_store_closure(promoted)
            return
        _LOG.info("SERVING CANARY: generation %d staged (window %d batches).", t, self.config.canary_requests)

    # --------------------------------------------------------------- canary

    def report_canary(self, ok: bool, divergence: Optional[float] = None) -> None:
        """One mirrored batch's verdict, reported by the batcher."""
        reject = promoted = None
        with self._lock:
            record = self._canary
            if record is None:
                return
            healthy = bool(ok)
            if (
                healthy
                and self.config.max_divergence is not None
                and divergence is not None
                and divergence > self.config.max_divergence
            ):
                healthy = False
            if healthy:
                self._canary_healthy += 1
            else:
                self._canary_failures += 1
            failures = self._canary_failures
            if failures > self.config.max_canary_failures:
                self._canary = None
                reject = record
            elif self._canary_healthy >= self.config.canary_requests:
                self._promote_locked(record, how="canary")
                promoted = record
        if promoted is not None:
            self._pin_store_closure(promoted)
        if reject is not None:
            self._reject(reject.iteration_number, reject.path, "canary failed (%d unhealthy batches)" % failures)

    # ------------------------------------------------------ externally gated

    def adopt(self, record: GenerationRecord, how: str = "fleet") -> None:
        """Installs an externally gated generation as the incumbent.

        The fleet flip path: `serving.fleet.FlipParticipant` runs the
        verify/load/smoke gate (`gate_generation`) and the coordinated
        canary itself, and calls this only after the fleet-wide
        all-or-none commit. The swap is the same atomic reference flip
        as the pool's own; a staged local canary is discarded.
        """
        with self._lock:
            self._attempted.add(self._identity(record.path))
            self._promote_locked(record, how=how)
        self._pin_store_closure(record)

    # ----------------------------------------------------- promote / reject

    def _promote_locked(self, record: GenerationRecord, how: str) -> None:
        from adanet_tpu_torch.observability import spans as spans_lib

        previous = self._active
        self._active = record
        self._canary = None
        self.flips += 1
        self._m_flips.inc()
        spans_lib.tracer().instant("serving.flip", generation=record.iteration_number, how=how)
        self.events.append(
            {
                "event": "flip",
                "iteration_number": record.iteration_number,
                "from": previous.iteration_number if previous else None,
                "how": how,
                "at": self._clock(),
            }
        )
        _LOG.warning(
            "SERVING FLIP: generation %s -> %d (%s gate passed).",
            previous.iteration_number if previous else None,
            record.iteration_number,
            how,
        )

    def _pin_store_closure(self, record: GenerationRecord) -> None:
        """Leases the promoted generation's blob closure against GC.

        Called after the pool lock is released: the pin does file I/O on
        a possibly remote store, and a stalled store must never hold
        `active_record()` callers on the lock. The digests come from the
        published store ref when there is one, else from the generation
        manifest (the same values). A failure is logged; serving never
        depends on the store.
        """
        if self._store is None:
            return
        try:
            from adanet_tpu_torch.store import leases as store_leases

            digests = set()
            ref = self._store.get_ref("serving", publisher.serving_ref_name(self._model_dir, record.iteration_number))
            if ref is not None:
                digests.update(ref.get("blobs", {}).values())
            else:
                with open(os.path.join(record.path, integrity.GENERATION_MANIFEST)) as f:
                    digests.update(json.load(f).get("digests", {}).values())
            if not digests:
                return
            owner = "serving-%d" % os.getpid()
            if self._store_lease is None:
                self._store_lease = store_leases.acquire(
                    self._store, owner=owner, ttl_secs=self._store_lease_ttl, digests=sorted(digests)
                )
            else:
                try:
                    store_leases.renew(self._store, self._store_lease, self._store_lease_ttl, add_digests=digests)
                except store_leases.LeaseExpiredError:
                    # The pin lapsed (a stalled poller) and GC may have
                    # swept in the gap: acquire the whole closure anew.
                    self._store_lease = store_leases.acquire(
                        self._store,
                        owner=owner,
                        ttl_secs=self._store_lease_ttl,
                        digests=sorted(set(self._store_lease.digests) | digests),
                    )
        except Exception:
            _LOG.exception(
                "Store lease pin for generation %d failed; serving continues unpinned.", record.iteration_number
            )

    def release_store_lease(self) -> None:
        """Drops this pool's GC pin (the shutdown path)."""
        if self._store is None or self._store_lease is None:
            return
        from adanet_tpu_torch.store import leases as store_leases

        store_leases.release(self._store, self._store_lease)
        self._store_lease = None

    def _reject(self, t: int, path: str, reason: str) -> None:
        from adanet_tpu_torch.observability import flightrec
        from adanet_tpu_torch.observability import spans as spans_lib

        with self._lock:
            self.rollbacks += 1
            self._m_rollbacks.inc()
            self._m_rejects.inc()
            incumbent = self._active
            self.events.append({"event": "rollback", "iteration_number": t, "reason": reason, "at": self._clock()})
        _LOG.error(
            "SERVING ROLLBACK: generation %d rejected (%s); serving stays on generation %s.",
            t,
            reason,
            incumbent.iteration_number if incumbent else None,
        )
        # A rejected flip is a forensic event even when no fault site
        # tripped (a rot mode is silent until the digest check).
        spans_lib.tracer().instant("serving.rollback", generation=t, reason=str(reason))
        flightrec.dump_installed("serving_rollback:gen-%d" % t)
        if not self.config.quarantine:
            return
        target = path + QUARANTINE_SUFFIX
        n = 0
        while os.path.exists(target):
            n += 1
            target = "%s%s.%d" % (path, QUARANTINE_SUFFIX, n)
        try:
            os.replace(path, target)
            _LOG.error("Quarantined rejected serving generation: %s", target)
        except OSError:
            pass
