"""adanet_tpu_torch: the PyTorch/CUDA port of adanet_tpu.

The port lives beside the JAX package and never imports it (nor jax,
flax or optax). Its layout mirrors `adanet_tpu/` so that each module's
counterpart is found by path. Hot-path kernels are hand-written CUDA
for Hopper (`ops/csrc/*.cu`), built at first use with `nvcc` and bound
with `ctypes`; each has a plain PyTorch version that runs only for CPU
tensors.

Every entry point runs on the card unless the caller passes
`device="cpu"` (`_device.resolve_device`). As the JAX package does, the
package exports `replay` and the AutoEnsemble estimators, imported at
first use, so that a process serving an exported program imports
`adanet_tpu_torch.ops` (the kernels' custom ops) and nothing more.
"""

import importlib

from adanet_tpu_torch._device import DEFAULT_DEVICE, resolve_device  # noqa: F401

_LAZY = {
    "replay": ("adanet_tpu_torch.replay", None),
    "AutoEnsembleEstimator": ("adanet_tpu_torch.autoensemble", "AutoEnsembleEstimator"),
    "AutoEnsembleSubestimator": ("adanet_tpu_torch.autoensemble", "AutoEnsembleSubestimator"),
    "AutoEnsembleTPUEstimator": ("adanet_tpu_torch.autoensemble", "AutoEnsembleTPUEstimator"),
}


def __getattr__(name):
    if name not in _LAZY:
        raise AttributeError("module %r has no attribute %r" % (__name__, name))
    module, attr = _LAZY[name]
    value = importlib.import_module(module)
    return value if attr is None else getattr(value, attr)
