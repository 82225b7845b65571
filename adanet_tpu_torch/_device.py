"""The port's device rule: run on the card unless the caller asks for the CPU.

Every entry point of `adanet_tpu_torch` takes a `device` argument that
defaults to `"cuda"`. A CUDA request on a machine without CUDA raises;
nothing silently carries on on the CPU. Callers that want the CPU (the
CPU test suite, offline comparisons) pass `device="cpu"` explicitly.
"""

from __future__ import annotations

from typing import Union

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: Union[str, torch.device, None] = None) -> torch.device:
    """Returns the `torch.device` to run on; raises when CUDA is asked
    for (the default) and is not available."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device %r requested but CUDA is not available; pass "
            "device='cpu' to run on the CPU" % (str(dev),)
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError("unsupported device %r" % (str(dev),))
    return dev
