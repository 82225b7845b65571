"""Example search spaces, ported from adanet_tpu/examples."""
