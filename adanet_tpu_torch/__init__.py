"""adanet_tpu_torch: the PyTorch/CUDA port of adanet_tpu.

The port lives beside the JAX package and never imports it (nor jax,
flax or optax). Its layout mirrors `adanet_tpu/` so that each module's
counterpart is found by path. Hot-path kernels are hand-written CUDA
for Hopper (`ops/csrc/*.cu`), built at first use with `nvcc` and bound
with `ctypes`; each has a plain PyTorch version that runs only for CPU
tensors.

Every entry point runs on the card unless the caller passes
`device="cpu"` (`_device.resolve_device`). As the JAX package does, the
package exports `replay` and the AutoEnsemble estimators.
"""

from adanet_tpu_torch._device import DEFAULT_DEVICE, resolve_device  # noqa: F401
from adanet_tpu_torch import replay  # noqa: F401,E402
from adanet_tpu_torch.autoensemble import (  # noqa: F401,E402
    AutoEnsembleEstimator,
    AutoEnsembleSubestimator,
    AutoEnsembleTPUEstimator,
)
