"""Model zoo: the port's NASNet-A, ResNet and EfficientNet."""

from adanet_tpu_torch.models.efficientnet import EfficientNet, EfficientNetBuilder  # noqa: F401
from adanet_tpu_torch.models.nasnet import (  # noqa: F401
    NasNetA,
    NasNetConfig,
    calc_reduction_layers,
    cifar_config,
    large_imagenet_config,
    mobile_imagenet_config,
)
from adanet_tpu_torch.models.resnet import ResNet, ResNetBuilder  # noqa: F401
