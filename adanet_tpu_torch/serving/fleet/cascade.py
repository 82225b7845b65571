"""Cascaded ensemble inference: answer cheap, fall through when unsure.

AdaNet's ensemble is a sum of members trained in cost order — the
first (cheapest) member alone answers a large fraction of requests
with the same argmax the full ensemble produces. This module turns
that structure into a latency weapon:

- **publish time** (`calibrate`): the cheap member's logits on a
  held-out stream are temperature-scaled (single-parameter NLL
  minimization — Guo et al.'s calibration recipe) and a confidence
  threshold is chosen as the smallest value whose above-threshold
  agreement with the full ensemble meets `target_agreement`. The
  record `{temperature, threshold, ...}` lands in
  `serving_signature.json` under `cascade`, next to the serialized
  cheap program (`cascade.pt2`) — the serving plane needs no
  labels, no recalibration, no model code.
- **serve time** (`clear_mask` via `serving.Batcher`): the cheap
  program runs first and every real row's calibrated confidence is
  scored against the threshold. Rows that clear are answered at
  `cascade_level=0`; only the residual rows fall through to the full
  ensemble, re-bucketed as a *smaller* padded batch over the same AOT
  bucket set — so the fleet pays the full-ensemble price for the
  ~per-row holdout fallthrough rate, not the far larger
  any-row-in-the-batch rate. Per-example independence of inference
  programs (the property padded bucket batching already relies on)
  makes each fallthrough row bit-identical to a cascade-free server's
  answer for that row: same program, same row bytes, row-independent
  computation. `clears` (all real rows clear) remains for the legacy
  per-batch mode (`BatcherConfig(split_rows=False)`) and callers that
  need a batch-level verdict.

A published record may also carry `shadow_divergence_bound`: the
serve-time ceiling on argmax disagreement between level-0 answers and
the full ensemble, enforced by the batcher's sampled shadow canary
(divergence past the bound rolls the replica back to ensemble-only
serving). `calibrate` derives it from the holdout with headroom.

Host-only module: logits arrive as host arrays (the batcher already
fetched them); everything here is numpy.
"""

from __future__ import annotations

import dataclasses
import logging
import math
from typing import Any, Callable, Dict, Optional

import numpy as np

_LOG = logging.getLogger("adanet_tpu_torch")

#: Signature block key and default logits leaf.
SIGNATURE_KEY = "cascade"
DEFAULT_LOGITS_KEY = "predictions"


@dataclasses.dataclass
class CascadeSpec:
    """Publish-time description of a generation's cheap member.

    `predict_fn(features) -> outputs` is the cheap member's prediction
    function (exported alongside the full ensemble). Calibration runs
    on `calibration_features` — the held-out stream; when
    `calibration_labels` is None the FULL ensemble's argmax stands in
    (the cascade then calibrates agreement with the ensemble it
    shields, which is exactly the property serving needs).
    """

    predict_fn: Callable
    calibration_features: Any
    calibration_labels: Optional[np.ndarray] = None
    logits_key: str = DEFAULT_LOGITS_KEY
    target_agreement: float = 0.995
    #: Provenance of the level-0 program, recorded in the signature's
    #: cascade block: "member" (truncated-prefix cheap ensemble, the
    #: Estimator's auto-published default) or "distilled" (a
    #: born-again KD student, `research/distill_to_serve`).
    source: str = "member"


def softmax(logits: np.ndarray, temperature: float = 1.0) -> np.ndarray:
    z = np.asarray(logits, np.float64) / float(temperature)
    z = z - z.max(axis=-1, keepdims=True)
    e = np.exp(z)
    return e / e.sum(axis=-1, keepdims=True)


def nll(logits: np.ndarray, labels: np.ndarray, temperature: float) -> float:
    probs = softmax(logits, temperature)
    rows = np.arange(len(labels))
    return float(
        -np.mean(np.log(np.clip(probs[rows, labels], 1e-12, 1.0)))
    )


def fit_temperature(
    logits: np.ndarray,
    labels: np.ndarray,
    lo: float = 0.05,
    hi: float = 20.0,
    iters: int = 60,
) -> float:
    """Single-parameter temperature scaling: argmin_T NLL(logits/T).

    Golden-section search over log T — the objective is unimodal in
    log-temperature for fixed logits, and 60 iterations pin the
    minimum far below the threshold-selection granularity.
    """
    logits = np.asarray(logits, np.float64)
    labels = np.asarray(labels, np.int64).reshape(-1)
    a, b = math.log(lo), math.log(hi)
    phi = (math.sqrt(5.0) - 1.0) / 2.0
    c, d = b - phi * (b - a), a + phi * (b - a)
    fc, fd = nll(logits, labels, math.exp(c)), nll(logits, labels, math.exp(d))
    for _ in range(iters):
        if fc <= fd:
            b, d, fd = d, c, fc
            c = b - phi * (b - a)
            fc = nll(logits, labels, math.exp(c))
        else:
            a, c, fc = c, d, fd
            d = a + phi * (b - a)
            fd = nll(logits, labels, math.exp(d))
    return float(math.exp((a + b) / 2.0))


def confidence(logits: np.ndarray, temperature: float) -> np.ndarray:
    """Per-row calibrated confidence: max temperature-scaled softmax."""
    return softmax(logits, temperature).max(axis=-1)


def pick_threshold(
    confidences: np.ndarray,
    agreements: np.ndarray,
    target_agreement: float,
) -> Dict[str, float]:
    """Smallest confidence threshold whose above-threshold agreement
    with the full ensemble meets `target_agreement`.

    Returns `{threshold, holdout_agreement, holdout_fallthrough_rate}`.
    When no threshold achieves the target (the cheap member disagrees
    even at its most confident), the threshold is set above any
    ACHIEVABLE confidence (2.0 > every softmax maximum) — the cascade
    degrades to always-fall-through, which costs latency, never
    correctness.
    """
    confidences = np.asarray(confidences, np.float64)
    agreements = np.asarray(agreements, bool)
    best = None
    # Candidate thresholds are the observed confidences, scanned from
    # most permissive: threshold c admits rows with confidence >= c.
    # One sort + one suffix cumsum makes this O(n log n) — a 100k-row
    # held-out stream must not stall the searcher's publish path.
    if len(confidences):
        order = np.argsort(confidences)
        conf_sorted = confidences[order]
        agree_sorted = agreements[order].astype(np.float64)
        suffix_agree = np.cumsum(agree_sorted[::-1])[::-1]
        n = len(conf_sorted)
        for i in range(n):
            # Ties share one admitted set; evaluate each threshold
            # value once, at its first (lowest-index) occurrence.
            if i and conf_sorted[i] == conf_sorted[i - 1]:
                continue
            admitted = n - i
            agreement = float(suffix_agree[i] / admitted)
            if agreement >= target_agreement:
                best = {
                    "threshold": float(conf_sorted[i]),
                    "holdout_agreement": agreement,
                    "holdout_fallthrough_rate": float(i) / n,
                }
                break
    if best is None:
        # No viable threshold: the cascade must degrade to
        # ALWAYS-fall-through. Confidences are softmax maxima (<= 1.0),
        # so 2.0 is unconditionally unreachable — including by a
        # serve-time row more confident than anything in the holdout,
        # which a max-observed-confidence sentinel would wrongly admit.
        # (2.0 rather than inf: the record lands in strict JSON.)
        best = {
            "threshold": 2.0,
            "holdout_agreement": 0.0,
            "holdout_fallthrough_rate": 1.0,
        }
    return best


def shadow_divergence_bound(
    holdout_agreement: float, target_agreement: float
) -> float:
    """Serve-time ceiling on level-0 argmax disagreement vs the ensemble.

    Expected disagreement on admitted rows is `1 - holdout_agreement`
    (<= `1 - target_agreement` by threshold construction); the bound
    triples that for sampling noise and floors at twice the target
    slack so a perfect holdout (agreement 1.0) never publishes a
    zero-tolerance bound that trips on the first disagreeing row.
    """
    return float(
        max(
            3.0 * (1.0 - float(holdout_agreement)),
            2.0 * (1.0 - float(target_agreement)),
        )
    )


def calibrate(
    cheap_logits: np.ndarray,
    full_logits: np.ndarray,
    labels: Optional[np.ndarray] = None,
    target_agreement: float = 0.995,
    logits_key: str = DEFAULT_LOGITS_KEY,
    source: str = "member",
) -> Dict[str, Any]:
    """The publish-time calibration record for the serving signature."""
    cheap_logits = np.asarray(cheap_logits, np.float64)
    full_logits = np.asarray(full_logits, np.float64)
    full_preds = full_logits.argmax(axis=-1)
    if labels is None:
        labels = full_preds
    temperature = fit_temperature(cheap_logits, labels)
    conf = confidence(cheap_logits, temperature)
    agree = cheap_logits.argmax(axis=-1) == full_preds
    record = pick_threshold(conf, agree, target_agreement)
    record.update(
        temperature=temperature,
        target_agreement=float(target_agreement),
        logits_key=logits_key,
        holdout_rows=int(len(conf)),
        source=str(source),
        shadow_divergence_bound=shadow_divergence_bound(
            record["holdout_agreement"], target_agreement
        ),
    )
    return record


def _logits_leaf(outputs: Any, logits_key: str) -> Optional[np.ndarray]:
    if isinstance(outputs, dict):
        leaf = outputs.get(logits_key)
        return None if leaf is None else np.asarray(leaf)
    return np.asarray(outputs)


def clear_mask(
    cascade: Dict[str, Any], cheap_outputs: Any, real_rows: int
) -> Optional[np.ndarray]:
    """Per-REAL-row boolean mask: True where the calibrated confidence
    clears the published threshold (the row is answerable at level 0).

    The mask covers exactly the first `real_rows` rows. Padding rows
    are excluded by construction: their zero features produce
    arbitrary confidences and must never force (or mask) a
    fallthrough — the contract `clears` documented per-batch now holds
    per row. Returns None when the outputs carry no scoreable logits
    leaf (the caller must fall through whole).
    """
    logits = _logits_leaf(
        cheap_outputs, cascade.get("logits_key", DEFAULT_LOGITS_KEY)
    )
    if logits is None or logits.ndim < 2:
        return None
    conf = confidence(
        logits[:real_rows], float(cascade.get("temperature", 1.0))
    )
    return conf >= float(cascade.get("threshold", np.inf))


def clears(
    cascade: Dict[str, Any], cheap_outputs: Any, real_rows: int
) -> bool:
    """True when every REAL row of the cheap outputs clears the margin.

    The batch-level verdict over `clear_mask` — padding rows are
    excluded there; see its docstring for the per-row contract.
    """
    mask = clear_mask(cascade, cheap_outputs, real_rows)
    return mask is not None and bool(np.all(mask))
