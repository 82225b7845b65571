"""Hand-written Hopper kernels of the port, with their plain versions.

| Kernel | Wrapper | Replaces (TPU kernel) |
|---|---|---|
| K0 copy | `_build.copy_tensor` | `adanet_tpu/ops/sepconv_kernels.py` `_platform_dependent_prunes` |
| K1 combine | `ensemble_kernels.fused_weighted_combine` (and `_members`) | `adanet_tpu/ops/ensemble_kernels.py` `_combine_kernel` |
| K2 sep-conv | `sepconv_kernels.fused_sep_conv` | `adanet_tpu/ops/sepconv_kernels.py` `_sepconv_kernel` |
| K3 cell | `cell_kernels.fused_cell` | `adanet_tpu/ops/cell_kernels.py` `_cell_kernel` |

Each wrapper counts its launches in a plain integer attribute
(`<wrapper>.launches`), incremented only where it launches its kernel
(K3: once per `fused_cell` call on the card, which runs several CUDA
kernels; `fused_cell.device_kernels` counts those). K2 and K3 take their
tiles from the store-persisted autotuner (`tuning.py`) when it has a
winner.

Importing this package registers K1 and K2 as the custom ops
`adanet_tpu_torch::weighted_combine` and `adanet_tpu_torch::sep_conv`,
which an exported program (`core/export.py`) calls: a process that
serves such a program imports `adanet_tpu_torch.ops` and nothing else of
the port.
"""

from adanet_tpu_torch.ops import _build
from adanet_tpu_torch.ops import ensemble_kernels, sepconv_kernels  # noqa: F401  (registers the custom ops)


def launch_counters():
    """{kernel name: wrapper} for every kernel of the port."""
    from adanet_tpu_torch.ops import cell_kernels, ensemble_kernels, sepconv_kernels

    return {
        "copy": _build.copy_tensor,
        "combine": ensemble_kernels.fused_weighted_combine,
        "sepconv": sepconv_kernels.fused_sep_conv,
        "cell": cell_kernels.fused_cell,
    }


def reset_launch_counts() -> None:
    for wrapper in launch_counters().values():
        wrapper.launches = 0


def launch_counts():
    return {name: w.launches for name, w in launch_counters().items()}
