"""EfficientDet: the backbones (EfficientNet, lite / edge, MobileNet,
MixNet, ResNet, CSP), BiFPN, class / box heads, the layers they share,
and AnchorNet; the names of ``ood_object_detection_tpu.models``."""
from .anchor_net import AnchorNet
from .backbone import (BACKBONE_DEFS, BackboneDef, BlockSpec,
                       GenericBackbone, ResNetBackbone, create_backbone,
                       round_channels)
from .bifpn import BiFpn, BiFpnLayer, Fnode, FpnCombine
from .csp import CSP_DEFS, CspBackbone
from .efficientdet import EfficientDet
from .heads import HeadNet
from .layers import (ConvBnAct, ResampleFeatureMap, SeparableConv,
                     SqueezeExcite, get_act, interpolate)

__all__ = ["AnchorNet", "BACKBONE_DEFS", "BackboneDef", "BiFpn",
           "BiFpnLayer", "BlockSpec", "CSP_DEFS", "ConvBnAct", "CspBackbone",
           "EfficientDet", "Fnode", "FpnCombine", "GenericBackbone",
           "HeadNet", "ResNetBackbone", "ResampleFeatureMap",
           "SeparableConv", "SqueezeExcite", "create_backbone", "get_act",
           "interpolate", "round_channels"]
