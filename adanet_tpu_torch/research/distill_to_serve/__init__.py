"""Born-again distillation into the serving cascade's level 0.

Port of research/distill_to_serve. A small student distilled against a
frozen AdaNet ensemble becomes the generation's `cascade.pt2` level-0
program: a single cheap program answering the easy rows, with the full
ensemble it was distilled from riding the batcher's shadow canary to
catch drift (`serving.cascade.shadow_divergence` rollback).
"""

from adanet_tpu_torch.research.distill_to_serve.distill import (
    DistillConfig,
    StudentMLP,
    distill_and_publish,
    distill_student,
    teacher_from_generation,
)

__all__ = [
    "DistillConfig",
    "StudentMLP",
    "distill_and_publish",
    "distill_student",
    "teacher_from_generation",
]
