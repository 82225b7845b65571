"""Core engine: iteration building, training, evaluation, checkpointing."""

from adanet_tpu_torch.core.tpu_estimator import TPUEstimator  # noqa: F401
