"""Padded batching over a small set of bucket sizes.

Port of adanet_tpu/serving/batcher.py with the cascade off. The batcher
concatenates the waiting requests, zero-pads them up to the smallest
bucket that holds them, executes the pool's incumbent program once, and
slices the outputs back per request. Padding rows are computed and
discarded: inference is per example, so a real row's answer does not
depend on its neighbours. Buckets keep the set of shapes the kernels see
small and fixed.

Thread contract: `execute` is NOT thread-safe; the serving front-end's
single executor thread is the serializer. The cascade and the canary
mirror come with a later slice.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, List, Sequence, Tuple

import numpy as np

from adanet_tpu_torch.observability import metrics as metrics_lib
from adanet_tpu_torch.robustness import faults
from adanet_tpu_torch.serving.model_pool import GenerationRecord, ModelPool, to_host

_LOG = logging.getLogger("adanet_tpu_torch")


@dataclasses.dataclass
class BatcherConfig:
    """`bucket_sizes` (sorted, ascending) are the only batch sizes the
    program runs at; the largest is the most rows per dispatch."""

    bucket_sizes: Sequence[int] = (1, 2, 4, 8, 16, 32)


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
        return record, split_rows(record.program(padded), sizes)
