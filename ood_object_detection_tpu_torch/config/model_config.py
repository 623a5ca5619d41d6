"""EfficientDet model configuration zoo (framework-free dataclasses).

A field-for-field copy of ``ood_object_detection_tpu.config.model_config``,
kept in this package so the PyTorch port never imports the JAX package
(whose ``__init__`` pulls in jax). tests/test_torch_config.py holds every
zoo entry equal to the JAX one.

Fields that describe the JAX/TPU path only (``nms_impl``, ``topk_recall``,
``remat_*``) are kept so configs round-trip unchanged; the port's
post-process is exact and picks its NMS kernel by tensor device.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple, Union

AspectRatios = Tuple[Union[float, Tuple[float, float]], ...]


@dataclasses.dataclass
class ModelConfig:
    # identity
    name: str = "tf_efficientdet_d1"
    backbone_name: str = "tf_efficientnet_b1"
    backbone_args: Dict[str, Any] = dataclasses.field(default_factory=dict)

    # input
    image_size: Tuple[int, int] = (640, 640)

    # head
    num_classes: int = 90

    # feature / anchor config
    min_level: int = 3
    max_level: int = 7
    num_scales: int = 3
    aspect_ratios: AspectRatios = ((1.0, 1.0), (1.4, 0.7), (0.7, 1.4))
    anchor_scale: Union[float, Tuple[float, ...]] = 4.0

    # FPN and head config
    pad_type: str = "same"          # 'same' = TF SAME; '' = symmetric (PyTorch-style)
    act_type: str = "swish"
    norm_eps: float = 1e-3
    norm_momentum: float = 0.01     # running-stat update fraction (torch convention)
    box_class_repeats: int = 3
    fpn_cell_repeats: int = 3
    fpn_channels: int = 88
    separable_conv: bool = True
    apply_resample_bn: bool = True
    conv_after_downsample: bool = False
    conv_bn_relu_pattern: bool = False
    downsample_type: str = "max"
    upsample_type: str = "nearest"
    redundant_bias: bool = True
    head_bn_level_first: bool = False   # weight layout toggle kept for ckpt-name parity
    head_act_type: Optional[str] = None
    # second pointwise class-predict head sharing the predict depthwise
    # stage (reference MetaHead.add_head, effdet/efficientdet.py:640-643;
    # enabled by infer.py --separate_head, infer.py:203-204)
    separate_head: bool = False

    fpn_name: Optional[str] = None

    # classification loss
    alpha: float = 0.15
    gamma: float = 0.0
    label_smoothing: float = 0.0
    legacy_focal: bool = False
    # The reference's active ('new') focal-loss path applies only the alpha
    # factor — the (1-p_t)^gamma modulation is disabled (reference
    # effdet/loss.py:75-95). Set True for the textbook focal loss.
    focal_modulation: bool = False

    # localization loss
    delta: float = 0.1
    box_loss_weight: float = 50.0

    # nms / post-process
    soft_nms: bool = False
    max_detection_points: int = 5000
    max_det_per_image: int = 100
    # 'per_anchor' = class-reduce then anchor top-k (fastest);
    # 'approx' = (anchor,class)-pair approx_max_k; 'exact' = full top-k
    topk_method: str = "per_anchor"
    topk_recall: float = 0.95
    # 'auto' = fused Pallas VMEM NMS kernel on TPU, lax loop elsewhere
    nms_impl: str = "auto"

    # compute
    compute_dtype: str = "float32"   # 'bfloat16' for TPU inference/training speed
    # gradient-checkpoint (remat) scopes beyond the backbone's
    # backbone_args['remat_stages']: recompute FPN-cell / head activations
    # in the backward pass instead of saving them. At D4@1024 the FPN+head
    # activations, not the backbone's, dominate train-step HBM — without
    # these the step OOMs at bs>=16 even with the full backbone rematted
    # (benchmarks/ROOFLINE.json).
    remat_fpn: bool = False
    remat_heads: bool = False

    @property
    def num_levels(self) -> int:
        return self.max_level - self.min_level + 1

    @property
    def num_anchors_per_location(self) -> int:
        return self.num_scales * len(self.aspect_ratios)

    def replace(self, **kwargs) -> "ModelConfig":
        return dataclasses.replace(self, **kwargs)


def _freeze(v):
    if isinstance(v, list):
        return tuple(_freeze(x) for x in v)
    return v


# Model zoo: per-model overrides of the defaults above. Carried over from the
# reference zoo table (effdet/config/model_config.py:88-576) — these are the
# published EfficientDet architecture hyperparameters (arXiv:1911.09070).
efficientdet_model_param_dict: Dict[str, Dict[str, Any]] = dict(
    # PyTorch-friendly padding variants
    efficientdet_d0=dict(
        backbone_name="efficientnet_b0", image_size=(512, 512), fpn_channels=64,
        fpn_cell_repeats=3, box_class_repeats=3, pad_type="", redundant_bias=False),
    efficientdet_d1=dict(
        backbone_name="efficientnet_b1", image_size=(640, 640), fpn_channels=88,
        fpn_cell_repeats=4, box_class_repeats=3, pad_type="", redundant_bias=False),
    efficientdet_d2=dict(
        backbone_name="efficientnet_b2", image_size=(768, 768), fpn_channels=112,
        fpn_cell_repeats=5, box_class_repeats=3, pad_type="", redundant_bias=False),
    efficientdet_d3=dict(
        backbone_name="efficientnet_b3", image_size=(896, 896), fpn_channels=160,
        fpn_cell_repeats=6, box_class_repeats=4, pad_type="", redundant_bias=False),
    efficientdet_d4=dict(
        backbone_name="efficientnet_b4", image_size=(1024, 1024), fpn_channels=224,
        fpn_cell_repeats=7, box_class_repeats=4),
    efficientdet_d5=dict(
        backbone_name="efficientnet_b5", image_size=(1280, 1280), fpn_channels=288,
        fpn_cell_repeats=7, box_class_repeats=4),

    # experimental alternates
    resdet50=dict(
        backbone_name="resnet50", image_size=(640, 640), fpn_channels=88,
        fpn_cell_repeats=4, box_class_repeats=3, pad_type="", act_type="relu",
        redundant_bias=False, separable_conv=False),
    cspresdet50=dict(
        backbone_name="cspresnet50", image_size=(640, 640),
        aspect_ratios=(1.0, 2.0, 0.5), fpn_channels=88, fpn_cell_repeats=4,
        box_class_repeats=3, pad_type="", act_type="leaky_relu",
        head_act_type="silu", downsample_type="max", upsample_type="bilinear",
        redundant_bias=False, separable_conv=False, head_bn_level_first=True),
    cspresdext50=dict(
        backbone_name="cspresnext50", image_size=(640, 640),
        aspect_ratios=(1.0, 2.0, 0.5), fpn_channels=88, fpn_cell_repeats=4,
        box_class_repeats=3, pad_type="", act_type="leaky_relu",
        redundant_bias=False, separable_conv=False, head_bn_level_first=True),
    cspresdext50pan=dict(
        backbone_name="cspresnext50", image_size=(640, 640),
        aspect_ratios=(1.0, 2.0, 0.5), fpn_channels=88, fpn_cell_repeats=3,
        box_class_repeats=3, pad_type="", act_type="leaky_relu", fpn_name="pan_fa",
        redundant_bias=False, separable_conv=False, head_bn_level_first=True),
    cspdarkdet53=dict(
        backbone_name="cspdarknet53", image_size=(640, 640),
        aspect_ratios=(1.0, 2.0, 0.5), fpn_channels=88, fpn_cell_repeats=4,
        box_class_repeats=3, pad_type="", act_type="leaky_relu",
        redundant_bias=False, separable_conv=False, head_bn_level_first=True),
    mixdet_m=dict(
        backbone_name="mixnet_m", image_size=(512, 512),
        aspect_ratios=(1.0, 2.0, 0.5), fpn_channels=64, fpn_cell_repeats=3,
        box_class_repeats=3, pad_type="", redundant_bias=False,
        head_bn_level_first=True),
    mixdet_l=dict(
        backbone_name="mixnet_l", image_size=(640, 640),
        aspect_ratios=(1.0, 2.0, 0.5), fpn_channels=88, fpn_cell_repeats=4,
        box_class_repeats=3, pad_type="", redundant_bias=False,
        head_bn_level_first=True),
    mobiledetv2_110d=dict(
        backbone_name="mobilenetv2_110d", image_size=(384, 384),
        aspect_ratios=(1.0, 2.0, 0.5), fpn_channels=48, fpn_cell_repeats=3,
        box_class_repeats=3, pad_type="", act_type="relu6", redundant_bias=False,
        head_bn_level_first=True),
    mobiledetv2_120d=dict(
        backbone_name="mobilenetv2_120d", image_size=(512, 512),
        aspect_ratios=(1.0, 2.0, 0.5), fpn_channels=56, fpn_cell_repeats=3,
        box_class_repeats=3, pad_type="", act_type="relu6", redundant_bias=False,
        head_bn_level_first=True),
    mobiledetv3_large=dict(
        backbone_name="mobilenetv3_large_100", image_size=(512, 512),
        aspect_ratios=(1.0, 2.0, 0.5), fpn_channels=64, fpn_cell_repeats=3,
        box_class_repeats=3, pad_type="", act_type="hard_swish",
        redundant_bias=False, head_bn_level_first=True),
    efficientdet_q0=dict(
        backbone_name="efficientnet_b0", image_size=(512, 512), fpn_channels=64,
        fpn_cell_repeats=3, box_class_repeats=3, pad_type="", fpn_name="qufpn_fa",
        redundant_bias=False, head_bn_level_first=True),
    efficientdet_q1=dict(
        backbone_name="efficientnet_b1", image_size=(640, 640), fpn_channels=88,
        fpn_cell_repeats=3, box_class_repeats=3, pad_type="", fpn_name="qufpn_fa",
        redundant_bias=False, head_bn_level_first=True),
    efficientdet_q2=dict(
        backbone_name="efficientnet_b2", image_size=(768, 768), fpn_channels=112,
        fpn_cell_repeats=4, box_class_repeats=3, pad_type="", fpn_name="qufpn_fa",
        redundant_bias=False, head_bn_level_first=True),
    efficientdet_w0=dict(
        backbone_name="efficientnet_b0", image_size=(512, 512),
        aspect_ratios=(1.0, 2.0, 0.5), fpn_channels=80, fpn_cell_repeats=3,
        box_class_repeats=3, pad_type="", redundant_bias=False,
        head_bn_level_first=True,
        backbone_args=dict(feature_location="depthwise")),
    efficientdet_es=dict(
        backbone_name="efficientnet_es", image_size=(512, 512),
        aspect_ratios=(1.0, 2.0, 0.5), fpn_channels=72, fpn_cell_repeats=3,
        box_class_repeats=3, pad_type="", act_type="relu", redundant_bias=False,
        head_bn_level_first=True, separable_conv=False),
    efficientdet_em=dict(
        backbone_name="efficientnet_em", image_size=(640, 640),
        aspect_ratios=(1.0, 2.0, 0.5), fpn_channels=96, fpn_cell_repeats=4,
        box_class_repeats=3, pad_type="", act_type="relu", redundant_bias=False,
        head_bn_level_first=True, separable_conv=False),
    efficientdet_lite0=dict(
        backbone_name="efficientnet_lite0", image_size=(512, 512), fpn_channels=64,
        fpn_cell_repeats=3, box_class_repeats=3, act_type="relu",
        redundant_bias=False, head_bn_level_first=True),

    # TF-ported variants (TF SAME padding)
    tf_efficientdet_d0=dict(
        backbone_name="tf_efficientnet_b0", image_size=(512, 512), fpn_channels=64,
        fpn_cell_repeats=3, box_class_repeats=3),
    tf_efficientdet_d1=dict(
        backbone_name="tf_efficientnet_b1", image_size=(640, 640), fpn_channels=88,
        fpn_cell_repeats=4, box_class_repeats=3),
    tf_efficientdet_d2=dict(
        backbone_name="tf_efficientnet_b2", image_size=(768, 768), fpn_channels=112,
        fpn_cell_repeats=5, box_class_repeats=3),
    tf_efficientdet_d3=dict(
        backbone_name="tf_efficientnet_b3", image_size=(896, 896), fpn_channels=160,
        fpn_cell_repeats=6, box_class_repeats=4),
    tf_efficientdet_d4=dict(
        backbone_name="tf_efficientnet_b4", image_size=(1024, 1024), fpn_channels=224,
        fpn_cell_repeats=7, box_class_repeats=4),
    tf_efficientdet_d5=dict(
        backbone_name="tf_efficientnet_b5", image_size=(1280, 1280), fpn_channels=288,
        fpn_cell_repeats=7, box_class_repeats=4),
    tf_efficientdet_d6=dict(
        backbone_name="tf_efficientnet_b6", image_size=(1280, 1280), fpn_channels=384,
        fpn_cell_repeats=8, box_class_repeats=5, fpn_name="bifpn_sum"),
    tf_efficientdet_d7=dict(
        backbone_name="tf_efficientnet_b6", image_size=(1536, 1536), fpn_channels=384,
        fpn_cell_repeats=8, box_class_repeats=5, anchor_scale=5.0,
        fpn_name="bifpn_sum"),
    tf_efficientdet_d7x=dict(
        backbone_name="tf_efficientnet_b7", image_size=(1536, 1536), fpn_channels=384,
        fpn_cell_repeats=8, box_class_repeats=5, anchor_scale=4.0, max_level=8,
        fpn_name="bifpn_sum"),

    tf_efficientdet_lite0=dict(
        backbone_name="tf_efficientnet_lite0", image_size=(512, 512), fpn_channels=64,
        fpn_cell_repeats=3, box_class_repeats=3, act_type="relu",
        redundant_bias=False),
    tf_efficientdet_lite1=dict(
        backbone_name="tf_efficientnet_lite1", image_size=(640, 640), fpn_channels=88,
        fpn_cell_repeats=4, box_class_repeats=3, act_type="relu"),
    tf_efficientdet_lite2=dict(
        backbone_name="tf_efficientnet_lite2", image_size=(768, 768), fpn_channels=112,
        fpn_cell_repeats=5, box_class_repeats=3, act_type="relu"),
    tf_efficientdet_lite3=dict(
        backbone_name="tf_efficientnet_lite3", image_size=(896, 896), fpn_channels=160,
        fpn_cell_repeats=6, box_class_repeats=4, act_type="relu"),
    tf_efficientdet_lite4=dict(
        backbone_name="tf_efficientnet_lite4", image_size=(1024, 1024), fpn_channels=224,
        fpn_cell_repeats=7, box_class_repeats=4, act_type="relu"),
)


def default_detection_model_configs(**overrides) -> ModelConfig:
    cfg = ModelConfig()
    return cfg.replace(**{k: _freeze(v) for k, v in overrides.items()})


def get_efficientdet_config(model_name: str = "tf_efficientdet_d1", **overrides) -> ModelConfig:
    """Config for a named zoo model, with optional field overrides."""
    params = dict(efficientdet_model_param_dict[model_name])
    params["name"] = model_name
    params.update(overrides)
    return default_detection_model_configs(**params)
