"""Health-gated generation flips: serve the newest healthy generation.

Port of adanet_tpu/serving/model_pool.py. A `ModelPool` follows the
generation chain (`<model_dir>/serving/gen-<t>/`, written by
`serving.publisher`) and swaps the served program under live traffic.
Every flip is gated:

1. **verify-on-load**: `publisher.verify_generation` checks every
   artifact against its SHA-256 digest and the manifest's self-checksum.
2. **load + smoke**: the generation's hermetic program (`serving.pt2`)
   is loaded onto the pool's device (`core.export.load_serving_program`,
   which on the card first runs the kernels' self-test) and executed once
   on a zeros sample built from the exported signature; so is the
   cascade's cheap program (`cascade.pt2`) when the signature has a
   cascade record, whose outputs must have the full program's structure.
   A load failure, non-finite outputs or an incongruent cascade reject
   the generation.

A generation that passes becomes the incumbent at once, by an atomic
reference swap, so every request is answered by exactly one complete
generation; a rejected one is logged and never retried, and the
incumbent keeps serving. The canary window, quarantine renames and
store leases come with ROADMAP item 10's second half.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from adanet_tpu_torch._device import resolve_device
from adanet_tpu_torch.robustness import faults
from adanet_tpu_torch.serving import publisher

_LOG = logging.getLogger("adanet_tpu_torch")


class NoServableGeneration(RuntimeError):
    """No generation has passed the health gate yet."""


class GateError(RuntimeError):
    """A generation failed the verify/load/smoke gate."""


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

    issues = publisher.verify_generation(path)
    if issues:
        raise GateError("verification failed: %s" % issues)
    t = publisher.read_iteration_number(path)
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
    """Follows the generation chain; owns the incumbent.

    Thread contract: `poll()` runs on one poller thread; `active_record`
    is called by the batcher's executor thread. State transitions happen
    under one lock; the flip itself is a reference swap.
    """

    def __init__(self, model_dir: str, device="cuda"):
        self._model_dir = model_dir
        self.device = resolve_device(device)
        self._lock = threading.Lock()
        self._active: Optional[GenerationRecord] = None
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
        self._m_rejects = reg.counter("serving.pool.rejects")
        flightrec.install_default(os.path.join(model_dir, flightrec.DEFAULT_SUBDIR))

    @property
    def active(self) -> Optional[GenerationRecord]:
        with self._lock:
            return self._active

    def active_record(self) -> GenerationRecord:
        with self._lock:
            if self._active is None:
                raise NoServableGeneration("no generation has passed the health gate yet")
            return self._active

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "active_generation": (
                    self._active.iteration_number if self._active else None
                ),
                "flips": self.flips,
                "rollbacks": self.rollbacks,
            }

    def poll(self) -> bool:
        """One discovery pass; returns True when a flip was attempted.
        Skips straight to the newest unattempted generation."""
        active = self.active
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
        try:
            record = gate_generation(path, self.device)
        except GateError as exc:
            self._reject(t, str(exc))
            return True
        self._promote(record)
        return True

    @staticmethod
    def _identity(path: str):
        try:
            st = os.stat(path)
        except OSError:
            return None
        return (st.st_ino, st.st_mtime_ns)

    def _promote(self, record: GenerationRecord) -> None:
        from adanet_tpu_torch.observability import spans as spans_lib

        with self._lock:
            previous = self._active
            self._active = record
            self.flips += 1
        self._m_flips.inc()
        spans_lib.tracer().instant("serving.flip", generation=record.iteration_number, how="gate")
        self.events.append(
            {
                "event": "flip",
                "iteration_number": record.iteration_number,
                "from": previous.iteration_number if previous else None,
                "at": time.monotonic(),
            }
        )
        _LOG.warning(
            "SERVING FLIP: generation %s -> %d.",
            previous.iteration_number if previous else None,
            record.iteration_number,
        )

    def _reject(self, t: int, reason: str) -> None:
        from adanet_tpu_torch.observability import flightrec
        from adanet_tpu_torch.observability import spans as spans_lib

        with self._lock:
            self.rollbacks += 1
            incumbent = self._active
        self._m_rejects.inc()
        self.events.append(
            {"event": "rollback", "iteration_number": t, "reason": reason, "at": time.monotonic()}
        )
        _LOG.error(
            "SERVING ROLLBACK: generation %d rejected (%s); serving stays on generation %s.",
            t,
            reason,
            incumbent.iteration_number if incumbent else None,
        )
        spans_lib.tracer().instant("serving.rollback", generation=t, reason=str(reason))
        flightrec.dump_installed("serving_rollback:gen-%d" % t)
