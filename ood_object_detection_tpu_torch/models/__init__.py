"""EfficientDet: EfficientNet backbone, BiFPN, class / box heads."""
from .efficientdet import EfficientDet

__all__ = ["EfficientDet"]
