"""Padded batching over a small set of bucket sizes, and the cascade.

Port of adanet_tpu/serving/batcher.py. The batcher
concatenates the waiting requests, zero-pads them up to the smallest
bucket that holds them, executes the pool's incumbent program once, and
slices the outputs back per request. Padding rows are computed and
discarded: inference is per example, so a real row's answer does not
depend on its neighbours. Buckets keep the set of shapes the kernels see
small and fixed.

With a generation that published a cascade (`serving.fleet.cascade`)
and `BatcherConfig.cascade`, the cheap level-0 program runs first and
each real row's calibrated confidence is scored against the published
threshold: rows that clear are answered at level 0, and only the
residual rows go to the full ensemble, gathered, re-bucketed to the
smallest bucket that holds them and zero-padded, so each such row's
answer is bit-identical to a cascade-free server's (same program, same
row, per-example computation). Padding rows never force a fallthrough
and never mask one. Every `shadow_every`-th dispatch that answered rows
at level 0 also runs the full ensemble on the batch and scores the
argmax disagreement of the level-0 rows; past the published bound the
cascade rolls back to ensemble-only serving for that generation.

The batcher also runs the pool's canary mirror: while a candidate
generation is staged (`ModelPool.canary_record`), each executed batch is
replayed on the candidate's program on the same padded bucket, and its
verdict (it ran, its outputs are finite, and their max absolute
divergence from the incumbent's) goes back to the pool's gate
(`report_canary`). A raising candidate counts as unhealthy and never
reaches the request.

Thread contract: `execute` is NOT thread-safe; the serving front-end's
single executor thread is the serializer.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from adanet_tpu_torch.observability import metrics as metrics_lib
from adanet_tpu_torch.robustness import faults
from adanet_tpu_torch.serving.model_pool import GenerationRecord, ModelPool, outputs_finite, to_host

_LOG = logging.getLogger("adanet_tpu_torch")


@dataclasses.dataclass
class BatcherConfig:
    """`bucket_sizes` (sorted, ascending) are the only batch sizes the
    program runs at; the largest is the most rows per dispatch."""

    bucket_sizes: Sequence[int] = (1, 2, 4, 8, 16, 32)
    #: Use the generation's cascade when one was published; False always
    #: runs the full ensemble.
    cascade: bool = True
    #: Per-row cascade splitting; False keeps the per-batch rule (any
    #: unclear row sends the whole padded batch to the full ensemble).
    split_rows: bool = True
    #: Every Nth cascade dispatch that answered rows at level 0 also
    #: shadows the full ensemble (0 disables the shadow and its rollback).
    shadow_every: int = 8
    #: Shadow-scored rows needed before divergence may roll back.
    shadow_min_rows: int = 64


def _leaves(tree) -> List[Any]:
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in _leaves(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [leaf for item in tree for leaf in _leaves(item)]
    return [tree]


def _map(fn, *trees):
    first = trees[0]
    if isinstance(first, dict):
        return {key: _map(fn, *(t[key] for t in trees)) for key in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_map(fn, *items) for items in zip(*trees))
    return fn(*trees)


def bucket_for(total_rows: int, bucket_sizes: Sequence[int]) -> int:
    """Smallest bucket holding `total_rows`; raises past the largest."""
    for size in bucket_sizes:
        if total_rows <= size:
            return size
    raise ValueError(
        "batch of %d rows exceeds the largest bucket (%d)" % (total_rows, max(bucket_sizes))
    )


def request_rows(features: Any) -> int:
    """Leading-dimension row count of a request's feature tree."""
    leaves = _leaves(features)
    if not leaves:
        raise ValueError("request has no feature leaves")
    return int(np.asarray(leaves[0]).shape[0])


def pad_batch(features_list: Sequence[Any], bucket: int) -> Tuple[Any, int]:
    """Concatenates request features and zero-pads rows to `bucket`.
    Returns (padded tree, real row count)."""

    def cat(*leaves):
        stacked = np.concatenate([np.asarray(leaf) for leaf in leaves], axis=0)
        total = stacked.shape[0]
        if total > bucket:
            raise ValueError("batch of %d rows exceeds bucket %d" % (total, bucket))
        if total < bucket:
            pad = np.zeros((bucket - total,) + stacked.shape[1:], stacked.dtype)
            stacked = np.concatenate([stacked, pad], axis=0)
        return stacked

    padded = _map(cat, *features_list)
    return padded, sum(request_rows(f) for f in features_list)


def split_rows(outputs: Any, sizes: Sequence[int]) -> List[Any]:
    """Copies a batched output tree to the host and slices it back into
    per-request trees."""
    outputs = to_host(outputs)
    out: List[Any] = []
    offset = 0
    for size in sizes:
        lo, hi = offset, offset + size
        out.append(_map(lambda x: x[lo:hi], outputs))
        offset = hi
    return out


def max_divergence(a: Any, b: Any) -> Optional[float]:
    """Max |a - b| over the float leaves of two host output trees."""
    worst = None
    for la, lb in zip(_leaves(a), _leaves(b)):
        la, lb = np.asarray(la), np.asarray(lb)
        if not np.issubdtype(la.dtype, np.floating):
            continue
        delta = float(np.max(np.abs(la - lb))) if la.size else 0.0
        worst = delta if worst is None else max(worst, delta)
    return worst


class Batcher:
    """Padded-bucket executor over the pool's incumbent generation."""

    def __init__(self, pool: ModelPool, config: BatcherConfig = None):
        self.pool = pool
        self.config = config or BatcherConfig()
        if list(self.config.bucket_sizes) != sorted(set(self.config.bucket_sizes)):
            raise ValueError(
                "bucket_sizes must be strictly ascending, got %r" % (self.config.bucket_sizes,)
            )
        reg = metrics_lib.registry()
        self._h_occupancy = reg.histogram(
            "serving.batcher.bucket_occupancy", boundaries=(0.25, 0.5, 0.75, 0.9, 1.0)
        )
        self._m_dispatches = reg.counter("serving.batcher.dispatches")
        self._m_cascade_cheap = reg.counter("serving.cascade.cheap_answers")
        self._m_cascade_fall = reg.counter("serving.cascade.fallthroughs")
        self._g_fallthrough = reg.gauge("serving.cascade.fallthrough_rate")
        self._m_rows_cheap = reg.counter("serving.cascade.row_cheap_answers")
        self._m_rows_fall = reg.counter("serving.cascade.row_fallthroughs")
        self._g_row_fallthrough = reg.gauge("serving.cascade.row_fallthrough_rate")
        self._g_shadow_divergence = reg.gauge("serving.cascade.shadow_divergence")
        self._m_cascade_rollbacks = reg.counter("serving.cascade.rollbacks")
        self._g_canary_divergence = reg.gauge("serving.batcher.canary_divergence")
        #: Cascade tier of the last dispatched batch (0 cheap, 1 full,
        #: None = no cascade ran), read by the frontend right after
        #: `execute` on its executor thread.
        self.last_cascade_level: Optional[int] = None
        #: Per-real-row provenance of the last batch (True = the full
        #: ensemble answered), or None when no cascade ran.
        self.last_row_fallthrough: Optional[np.ndarray] = None
        #: None while the cascade is healthy; the rollback's record once
        #: the shadow tripped the published bound.
        self.cascade_rollback: Optional[Dict[str, Any]] = None
        self._cascade_seq = 0
        self._shadow_generation: Optional[int] = None
        self._shadow_rows = 0
        self._shadow_disagree = 0
        self._cascade_digests: Dict[int, Optional[str]] = {}

    @property
    def max_batch(self) -> int:
        return max(self.config.bucket_sizes)

    def execute(self, features_list: Sequence[Any]) -> Tuple[GenerationRecord, List[Any]]:
        """Executes one formed batch; returns (generation, per-request
        outputs). The generation is captured once: a concurrent flip
        affects only later batches."""
        record = self.pool.active_record()
        sizes = [request_rows(f) for f in features_list]
        real_rows = sum(sizes)
        bucket = bucket_for(real_rows, self.config.bucket_sizes)
        padded, _ = pad_batch(features_list, bucket)
        self._m_dispatches.inc()
        self._h_occupancy.observe(real_rows / float(bucket))
        faults.trip("serving.batch_execute")
        self.last_cascade_level = None
        self.last_row_fallthrough = None
        outputs = None
        if self._cascade_active(record):
            outputs = self._execute_cascade(record, padded, real_rows)
        if outputs is None:
            outputs = record.program(padded)
        outputs = to_host(outputs)
        split = split_rows(outputs, sizes)
        self._mirror_canary(padded, outputs)
        return record, split

    # -------------------------------------------------------------- cascade

    def _cascade_active(self, record: GenerationRecord) -> bool:
        """Cascade published, enabled, and not rolled back for `record`."""
        if not self.config.cascade:
            return False
        if getattr(record, "cascade_program", None) is None or getattr(record, "cascade", None) is None:
            return False
        rollback = self.cascade_rollback
        return not (rollback is not None and rollback.get("generation") == record.iteration_number)

    def _execute_cascade(self, record: GenerationRecord, padded: Any, real_rows: int) -> Optional[Any]:
        """Runs the level-0 program and resolves the per-row cascade.
        Returns the finished host output tree, or None when the whole
        padded batch must run on the full ensemble (no clear row,
        unscoreable outputs, or the per-batch rule with an unclear row)."""
        from adanet_tpu_torch.serving.fleet import cascade as cascade_lib

        if self._shadow_generation != record.iteration_number:
            # A new generation starts a fresh shadow verdict.
            self._shadow_generation = record.iteration_number
            self._shadow_rows = 0
            self._shadow_disagree = 0
            self._cascade_seq = 0
            self.cascade_rollback = None
        cheap = to_host(record.cascade_program(padded))
        mask = cascade_lib.clear_mask(record.cascade, cheap, real_rows)
        rows_clear = int(mask.sum()) if mask is not None else 0
        rows_fall = real_rows - rows_clear
        self._m_rows_cheap.inc(rows_clear)
        self._m_rows_fall.inc(rows_fall)
        scored = self._m_rows_cheap.value + self._m_rows_fall.value
        self._g_row_fallthrough.set(self._m_rows_fall.value / float(scored))
        if mask is not None and rows_fall == 0:
            outputs: Optional[Any] = cheap
            self.last_cascade_level = 0
            self.last_row_fallthrough = np.zeros(real_rows, bool)
            self._m_cascade_cheap.inc()
        elif mask is None or rows_clear == 0 or not self.config.split_rows:
            outputs = None
            self.last_cascade_level = 1
            self.last_row_fallthrough = np.ones(real_rows, bool)
            self._m_cascade_fall.inc()
        else:
            outputs = self._execute_residual(record, padded, cheap, mask)
            self.last_cascade_level = 1
            self.last_row_fallthrough = np.ones(real_rows, bool) if outputs is None else ~mask
            self._m_cascade_fall.inc()
        answered = self._m_cascade_cheap.value + self._m_cascade_fall.value
        self._g_fallthrough.set(self._m_cascade_fall.value / float(answered))
        if rows_clear and mask is not None and self.config.shadow_every > 0:
            self._cascade_seq += 1
            if self._cascade_seq % self.config.shadow_every == 0:
                self._shadow_score(record, padded, cheap, mask)
                if self.cascade_rollback is not None:
                    # The shadow condemned level 0 on this very batch:
                    # the whole batch is answered by the full program.
                    self.last_cascade_level = 1
                    self.last_row_fallthrough = np.ones(real_rows, bool)
                    return None
        return outputs

    def _execute_residual(self, record: GenerationRecord, padded: Any, cheap: Any, mask: np.ndarray):
        """Runs only the unclear rows on the full ensemble (gathered from
        the padded batch, re-bucketed, zero-padded) and scatters their
        answers into the level-0 outputs; None when the two programs'
        output trees are not congruent."""
        residual_idx = np.flatnonzero(~mask)
        residual = _map(lambda leaf: np.asarray(leaf)[residual_idx], padded)
        rbucket = bucket_for(len(residual_idx), self.config.bucket_sizes)
        rpadded, _ = pad_batch([residual], rbucket)
        self._h_occupancy.observe(len(residual_idx) / float(rbucket))
        full = to_host(record.program(rpadded))

        def scatter(cheap_leaf, full_leaf):
            out = np.asarray(cheap_leaf).copy()
            out[residual_idx] = np.asarray(full_leaf)[: len(residual_idx)]
            return out

        try:
            return _map(scatter, cheap, full)
        except (ValueError, TypeError, KeyError) as exc:
            _LOG.error("Cascade scatter failed for generation %d (output trees not congruent): %s; serving the "
                       "batch from the full ensemble.", record.iteration_number, exc)
            return None

    def _shadow_score(self, record: GenerationRecord, padded: Any, cheap: Any, mask: np.ndarray) -> None:
        """Scores this batch's level-0 rows against the full ensemble run
        on the same padded batch: their argmax disagreement folds into a
        decayed running rate (`serving.cascade.shadow_divergence`); past
        the published bound, after `shadow_min_rows` rows, the cascade
        rolls back for this generation."""
        from adanet_tpu_torch.serving.fleet import cascade as cascade_lib

        spec = record.cascade
        try:
            full = to_host(record.program(padded))
        except Exception as exc:
            _LOG.error("Cascade shadow execution failed for generation %d: %s: %s",
                       record.iteration_number, type(exc).__name__, exc)
            return
        key = spec.get("logits_key", cascade_lib.DEFAULT_LOGITS_KEY)
        cheap_logits = cascade_lib._logits_leaf(cheap, key)
        full_logits = cascade_lib._logits_leaf(full, key)
        if cheap_logits is None or full_logits is None:
            return
        idx = np.flatnonzero(mask)
        disagree = int(np.sum(cheap_logits[idx].argmax(axis=-1) != full_logits[idx].argmax(axis=-1)))
        # Halve the window once it saturates, so an old clean epoch
        # cannot dilute fresh drift forever.
        if self._shadow_rows > 4096:
            self._shadow_rows //= 2
            self._shadow_disagree //= 2
        self._shadow_rows += len(idx)
        self._shadow_disagree += disagree
        rate = self._shadow_disagree / float(self._shadow_rows)
        self._g_shadow_divergence.set(rate)
        bound = float(spec.get("shadow_divergence_bound", cascade_lib.shadow_divergence_bound(
            spec.get("holdout_agreement", 1.0), spec.get("target_agreement", 0.995))))
        if self._shadow_rows >= self.config.shadow_min_rows and rate > bound:
            self._rollback_cascade(record, rate, bound)

    def _rollback_cascade(self, record: GenerationRecord, rate: float, bound: float) -> None:
        """Ensemble-only serving for this generation from the next
        dispatch, with the reason on the flight recorder."""
        from adanet_tpu_torch.observability import flightrec
        from adanet_tpu_torch.observability import spans as spans_lib

        t = record.iteration_number
        reason = "shadow divergence %.4f past published bound %.4f over %d shadowed rows" % (
            rate, bound, self._shadow_rows)
        self.cascade_rollback = {
            "generation": t,
            "reason": reason,
            "shadow_divergence": float(rate),
            "bound": float(bound),
            "shadow_rows": int(self._shadow_rows),
        }
        self._m_cascade_rollbacks.inc()
        _LOG.error("CASCADE ROLLBACK: generation %d serves ensemble-only (%s).", t, reason)
        spans_lib.tracer().instant("serving.cascade.rollback", generation=t, reason=reason)
        flightrec.dump_installed("cascade_shadow_rollback:gen-%d" % t)

    def cascade_stats(self) -> Dict[str, Any]:
        """The operator's cascade snapshot."""
        try:
            record: Optional[GenerationRecord] = self.pool.active_record()
        except Exception:
            record = None
        spec = getattr(record, "cascade", None) if record else None
        published = spec is not None and getattr(record, "cascade_program", None) is not None
        out: Dict[str, Any] = {
            "enabled": bool(self.config.cascade),
            "mode": "row" if self.config.split_rows else "batch",
            "published": bool(published),
            "active": bool(record is not None and self._cascade_active(record) and published),
            "generation": record.iteration_number if record is not None else None,
            "row_fallthrough_rate": self._g_row_fallthrough.value,
            "fallthrough_rate": self._g_fallthrough.value,
            "shadow_divergence": self._g_shadow_divergence.value,
            "shadow_rows": int(self._shadow_rows),
            "rollback": self.cascade_rollback,
        }
        if published:
            out.update(
                threshold=spec.get("threshold"),
                temperature=spec.get("temperature"),
                source=spec.get("source", "member"),
                shadow_divergence_bound=spec.get("shadow_divergence_bound"),
                program_digest=self._cascade_digest(record),
            )
        return out

    def _cascade_digest(self, record: GenerationRecord) -> Optional[str]:
        """The level-0 program's digest from the generation's manifest,
        cached per generation."""
        t = record.iteration_number
        if t not in self._cascade_digests:
            from adanet_tpu_torch.serving import publisher

            program = (getattr(record, "cascade", None) or {}).get("program")
            path = getattr(record, "path", None)
            self._cascade_digests[t] = publisher.read_digests(path).get(program) if path and program else None
            for old in [k for k in self._cascade_digests if k < t - 2]:
                del self._cascade_digests[old]
        return self._cascade_digests[t]

    # --------------------------------------------------------------- canary

    def _mirror_canary(self, padded: Any, incumbent_outputs: Any) -> None:
        """Replays the batch on a staged candidate and reports its health.

        `incumbent_outputs` may hold cascade level-0 answers (the whole
        batch, or the clear rows of a per-row split); their divergence
        from the candidate's full program would measure the calibration,
        not the candidate, so the divergence is skipped whenever any row
        was answered at level 0 (finiteness still counts).
        """
        candidate = self.pool.canary_record()
        if candidate is None:
            return
        any_cheap = self.last_cascade_level == 0 or (
            self.last_row_fallthrough is not None and not bool(np.all(self.last_row_fallthrough))
        )
        try:
            mirrored = to_host(candidate.program(padded))
            ok = outputs_finite(mirrored)
            divergence = None if any_cheap else max_divergence(incumbent_outputs, mirrored)
        except Exception as exc:
            _LOG.error("Canary execution failed for generation %d: %s: %s", candidate.iteration_number,
                       type(exc).__name__, exc)
            ok, divergence = False, None
        if divergence is not None:
            self._g_canary_divergence.set(divergence)
        self.pool.report_canary(ok, divergence)
