"""EfficientDet: the backbones (EfficientNet, lite / edge, MobileNet,
MixNet, ResNet, CSP), BiFPN, class / box heads, and AnchorNet."""
from .anchor_net import AnchorNet
from .backbone import (BACKBONE_DEFS, BackboneDef, BlockSpec,
                       GenericBackbone, ResNetBackbone, create_backbone,
                       round_channels)
from .csp import CSP_DEFS, CspBackbone
from .efficientdet import EfficientDet

__all__ = ["AnchorNet", "BACKBONE_DEFS", "BackboneDef", "BlockSpec",
           "CSP_DEFS", "CspBackbone", "EfficientDet", "GenericBackbone",
           "ResNetBackbone", "create_backbone", "round_channels"]
