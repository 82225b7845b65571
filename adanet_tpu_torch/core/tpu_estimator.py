"""TPUEstimator: the card's windowed Estimator.

Port of adanet_tpu/core/tpu_estimator.py, under the same name so that a
reader finds its counterpart; here it is the Estimator as the card runs
it for throughput:

- `iterations_per_loop=16`: windows of 16 steps run back to back with
  one host read a window (`Iteration.train_steps`), the analogue of the
  reference's device loop;
- `predict_batch_size`: every prediction batch is padded on the host to
  that size, so the card always sees one shape, and the outputs are
  sliced back to the true rows; a larger batch raises;
- `embedding_tables_on_host=True`: `predict` runs on the CPU by the
  caller's choice (a model too large for the card's memory; the
  reference's TPUEmbedding inference fallback), with one warning per
  estimator. It never runs there because a card or a kernel is missing.
"""

from __future__ import annotations

import collections
import logging
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from adanet_tpu_torch.core.estimator import Estimator
from adanet_tpu_torch.utils.batches import batch_example_count


def _pad_to(features, size: int):
    """`features` with every array's leading dimension zero-padded to
    `size` (numpy, on the host)."""
    if isinstance(features, dict):
        return {key: _pad_to(value, size) for key, value in features.items()}
    if isinstance(features, (list, tuple)):
        return type(features)(_pad_to(item, size) for item in features)
    arr = features.cpu().numpy() if torch.is_tensor(features) else np.asarray(features)
    if arr.ndim == 0 or arr.shape[0] == size:
        return arr
    return np.pad(arr, [(0, size - arr.shape[0])] + [(0, 0)] * (arr.ndim - 1))


class TPUEstimator(Estimator):
    """`Estimator` with windows of 16 steps and padded prediction."""

    def __init__(
        self,
        *args,
        iterations_per_loop: int = 16,
        predict_batch_size: Optional[int] = None,
        embedding_tables_on_host: bool = False,
        **kwargs,
    ):
        super().__init__(*args, iterations_per_loop=iterations_per_loop, **kwargs)
        if predict_batch_size is not None and predict_batch_size < 0:
            raise ValueError("predict_batch_size must be >= 1 (or 0 to disable).")
        self._predict_batch_size = predict_batch_size
        self._embedding_tables_on_host = bool(embedding_tables_on_host)
        self._warned_cpu_predict = False

    def predict(
        self,
        input_fn: Callable[[], Iterator],
        predict_batch_size: Optional[int] = None,
        on_cpu: Optional[bool] = None,
    ):
        """Yields per-batch predictions. With a `predict_batch_size`
        (the argument, else the constructor's) every batch is padded to
        it and the outputs sliced back to its rows; 0 turns padding off.
        `on_cpu` (default: the constructor's `embedding_tables_on_host`)
        predicts on the CPU."""
        if on_cpu is None:
            on_cpu = self._embedding_tables_on_host
            if on_cpu and not self._warned_cpu_predict:
                # Once an estimator: a serving process calls predict() per
                # stream.
                self._warned_cpu_predict = True
                logging.getLogger(__name__).warning(
                    "The model's tables stay on the host (embedding_tables_on_host); predicting on the CPU."
                )
        batch_size = predict_batch_size if predict_batch_size is not None else self._predict_batch_size
        if batch_size is not None and batch_size < 0:
            raise ValueError("predict_batch_size must be >= 1 (or 0 to disable), got %d" % batch_size)
        if not batch_size:
            yield from super().predict(input_fn, on_cpu=on_cpu)
            return

        sizes = collections.deque()

        def padded_input_fn():
            for batch in input_fn():
                features = batch[0] if isinstance(batch, tuple) else batch
                n = batch_example_count(features)
                if n > batch_size:
                    raise ValueError("Input batch of %d examples exceeds predict_batch_size=%d." % (n, batch_size))
                sizes.append(n)
                yield (_pad_to(features, batch_size), None)

        for predictions in super().predict(padded_input_fn, on_cpu=on_cpu):
            n = sizes.popleft()  # bounded memory on an unbounded stream
            yield {key: value[:n] if value.dim() >= 1 else value for key, value in predictions.items()}
