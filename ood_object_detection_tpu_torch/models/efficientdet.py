"""The assembled EfficientDet (backbone + BiFPN + class / box heads).

Port of ``ood_object_detection_tpu.models.efficientdet``. The public
methods keep the JAX package's layouts: images ``[B, H, W, 3]`` in, and
per-level NHWC features / head outputs (class ``[B, H, W, A*C]``, box
``[B, H, W, A*4]``) out. Inside, every module runs NCHW tensors in
``torch.channels_last`` memory, so moving between the two layouts is a
free ``permute`` view; the K2 kernel reads the NHWC view of the class
head's outputs in place.

The input is cast to ``config.compute_dtype`` once, as in the JAX model
(``efficientdet.py:93``); the parameters stay f32 and are cast per op.

Train / eval mode selects the BatchNorm statistics, as the JAX model's
``training`` flag does: ``train_bn(freeze_bn)`` puts the model in train
mode with the BatchNorm of the frozen scope in eval mode (the JAX train
step's ``freeze_bn``). The staged methods of the episodic harness
(``backbone_features``, ``fpn_features``, ``class_head``, ``box_head``)
take the normalisation from the module's mode; ``layers.
batch_stats_mode`` switches a subnet to batch statistics that write
nothing.

``config.remat_fpn`` / ``remat_heads`` recompute each FPN cell's and each
head's activations in the backward pass (``layers.remat``), and the
backbone's ``remat_stages`` its first stages' blocks; the running
statistics are written once. ``forward`` and ``backbone_features`` take
the stochastic-depth generator of a train step (``generator``), which a
backbone with ``drop_path_rate > 0`` draws its drop masks from.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.func import functional_call

from ..config.model_config import ModelConfig
from ..utils.profiling import span
from .backbone import create_backbone
from .bifpn import BiFpn
from .heads import PRIOR_BIAS, HeadNet
from .layers import Conv2d, init_conv_, remat

FREEZE_BN_SCOPES = ("none", "backbone", "all")


def _nchw(xs: List[torch.Tensor]) -> List[torch.Tensor]:
    return [x.permute(0, 3, 1, 2) for x in xs]


def _nhwc(xs: List[torch.Tensor]) -> List[torch.Tensor]:
    return [x.permute(0, 2, 3, 1) for x in xs]


class EfficientDet(nn.Module):

    def __init__(self, config: ModelConfig):
        super().__init__()
        self.config = config
        self.compute_dtype = getattr(torch, config.compute_dtype)
        self.backbone, feature_info = create_backbone(
            config.backbone_name, **(config.backbone_args or {}))
        self.feature_info = tuple(feature_info)
        self.fpn = BiFpn(config, self.feature_info)
        self.class_net = HeadNet(config, config.num_classes,
                                 separate_head=config.separate_head)
        self.box_net = HeadNet(config, 4)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Draw every conv from the JAX package's initialiser for it, in
        module order, from ``generator``; the class head's predict bias
        starts at the focal prior (``predict_sep``'s too). BatchNorm and
        the BiFPN edge weights keep their constructed values (1, 0, mean 0,
        var 1; ones)."""
        for module in self.modules():
            if isinstance(module, Conv2d):
                init_conv_(module, generator)
        self.class_net.predict_bias().fill_(PRIOR_BIAS)
        if self.class_net.predict_sep is not None:
            self.class_net.predict_sep.bias.fill_(PRIOR_BIAS)

    def train_bn(self, freeze_bn: str = "none") -> "EfficientDet":
        """Train mode, with the BatchNorm of the ``freeze_bn`` scope in eval
        mode: 'none', 'backbone' (backbone BN frozen) or 'all' (every BN
        frozen). Frozen BN normalises with, and keeps, its running
        statistics; gradients still reach its scale and bias."""
        if freeze_bn not in FREEZE_BN_SCOPES:
            raise ValueError(f"freeze_bn {freeze_bn!r} not in "
                             f"{FREEZE_BN_SCOPES}")
        self.train()
        if freeze_bn != "none":
            self.backbone.eval()
        if freeze_bn == "all":
            for module in (self.fpn, self.class_net, self.box_net):
                module.eval()
        return self

    def _image(self, x: torch.Tensor) -> torch.Tensor:
        return x.permute(0, 3, 1, 2).to(self.compute_dtype)

    def backbone_features(self, x: torch.Tensor,
                          generator: Optional[torch.Generator] = None
                          ) -> List[torch.Tensor]:
        """Image [B, H, W, 3] -> [P3, P4, P5] backbone features (NHWC)."""
        return _nhwc(self.backbone(self._image(x), generator))

    def fpn_features(self, feats: List[torch.Tensor]) -> List[torch.Tensor]:
        """Backbone features -> FPN pyramid P3..P7 (NHWC)."""
        return _nhwc(self.fpn(_nchw(feats)))

    def _heads(self, activs: List[torch.Tensor]
               ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        if self.config.remat_heads:
            return (_nhwc(remat(self.class_net, activs)),
                    _nhwc(remat(self.box_net, activs)))
        return _nhwc(self.class_net(activs)), _nhwc(self.box_net(activs))

    def heads(self, activs: List[torch.Tensor]
              ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        """Pyramid (NHWC) -> (class outputs, box outputs) per level."""
        return self._heads(_nchw(activs))

    def class_head(self, activs: List[torch.Tensor], ret_activs: bool = False,
                   level_offset: int = 0, force_batch_stats: bool = False,
                   heads: str = "main",
                   params: Optional[Dict[str, torch.Tensor]] = None):
        """Pyramid (NHWC) -> class outputs (NHWC) of the levels from
        ``level_offset`` on; see ``HeadNet.forward`` for ``ret_activs``,
        ``force_batch_stats`` and ``heads``. ``params`` (class head
        parameter name -> tensor) stands in for the head's own parameters,
        as the JAX package applies the model with another ``class_net``
        subtree: the MAML inner loop's fast weights."""
        args = (_nchw(activs), ret_activs, level_offset, force_batch_stats,
                heads)
        out = self.class_net(*args) if params is None else \
            functional_call(self.class_net, params, args)
        if isinstance(out, tuple):
            return tuple(_nhwc(o) for o in out)
        return _nhwc(out)

    def box_head(self, activs: List[torch.Tensor]) -> List[torch.Tensor]:
        """Pyramid (NHWC) -> box outputs per level (NHWC)."""
        return _nhwc(self.box_net(_nchw(activs)))

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        """Image [B, H, W, 3] -> (class [B, H, W, A*C], box [B, H, W, A*4])
        per level; ``generator`` draws the backbone's drop masks."""
        with span("odt.forward"):
            return self._heads(self.fpn(self.backbone(self._image(x),
                                                      generator)))
