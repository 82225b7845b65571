"""ImageNet AutoEnsemble workload: ResNet-50 + EfficientNet-B0 candidates.

Port of research/imagenet_autoensemble: the input pipeline over the
standard ImageNet folder layout and its synthetic stand-in
(`imagenet_data`, a copy), and the trainer CLI that wires the two
families through the port's `AutoEnsembleEstimator` (`trainer`).
"""
