"""Model zoo: the port's NASNet-A."""

from adanet_tpu_torch.models.nasnet import (  # noqa: F401
    NasNetA,
    NasNetConfig,
    calc_reduction_layers,
    cifar_config,
    large_imagenet_config,
    mobile_imagenet_config,
)
