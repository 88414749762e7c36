"""The paper's own evaluation models (Table 4) as engine-buildable configs.

These are CNN chains for the cold-inference engine (host-scale), not
ArchConfigs for the distributed decoder — kept separate deliberately. Sizes
are scaled for this container; ``width``/``image`` control cost.
[ResNet: He'16; MobileNet: Howard'17; SqueezeNet: Iandola'16; AlexNet:
Krizhevsky'12]
"""
from repro_torch.models.cnn import build_cnn, CNN_NAMES  # noqa: F401

CONFIGS = {name: name for name in CNN_NAMES}
