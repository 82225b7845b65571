"""The replicated serving plane's pieces the port has so far.

Port of adanet_tpu/serving/fleet. Only `cascade` (a copy: cascaded
ensemble inference, calibrated at publish time, resolved per row by
`serving.Batcher`) is here; the balancer, the flip coordinator, the
replicas and the transport come with ROADMAP item 10.3.
"""

from adanet_tpu_torch.serving.fleet.cascade import CascadeSpec, calibrate

__all__ = ["CascadeSpec", "calibrate"]
