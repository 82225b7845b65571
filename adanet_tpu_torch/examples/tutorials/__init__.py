"""Tutorials of the port (adanet_tpu/examples/tutorials)."""
