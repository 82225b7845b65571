"""Hand-written Hopper kernels of the port, with their plain versions.

| Kernel | Wrapper | Replaces (TPU kernel) |
|---|---|---|
| K0 copy | `_build.copy_tensor` | `adanet_tpu/ops/sepconv_kernels.py` `_platform_dependent_prunes` |
| K1 combine | `ensemble_kernels.fused_weighted_combine` | `adanet_tpu/ops/ensemble_kernels.py` `_combine_kernel` |
| K2 sep-conv | `sepconv_kernels.fused_sep_conv` | `adanet_tpu/ops/sepconv_kernels.py` `_sepconv_kernel` |

Each wrapper counts its launches in a plain integer attribute
(`<wrapper>.launches`), incremented only where it launches its kernel.
"""

from adanet_tpu_torch.ops import _build


def launch_counters():
    """{kernel name: wrapper} for every kernel of the port."""
    from adanet_tpu_torch.ops import ensemble_kernels, sepconv_kernels

    return {
        "copy": _build.copy_tensor,
        "combine": ensemble_kernels.fused_weighted_combine,
        "sepconv": sepconv_kernels.fused_sep_conv,
    }


def reset_launch_counts() -> None:
    for wrapper in launch_counters().values():
        wrapper.launches = 0


def launch_counts():
    return {name: w.launches for name, w in launch_counters().items()}
