"""Sequence parallelism: exact ring attention over sequence shards.

Port of adanet_tpu/parallel. `SequenceMesh` stands in for the JAX mesh's
sequence axis: p shards in one process, or one shard a process over a
process group of its own (`SequenceMesh.connect`).
"""

from adanet_tpu_torch.parallel.ring_attention import SequenceMesh, full_attention, ring_attention

__all__ = ["SequenceMesh", "full_attention", "ring_attention"]
