"""Box math, labeling, losses, post-processing and the hand-written CUDA
kernels: K1 NMS (``cuda_nms``), K2 key + energy reduce (``cuda_reduce``),
K3 anchor match and K4 target encode (``cuda_labeler``).

The names re-exported here are the JAX package's
(``ood_object_detection_tpu.ops``), with the JAX meaning:
``batched_nms`` / ``batched_soft_nms`` are the single-image per-class
functions of ``ops/nms.py``. The batched K1 wrapper of the same name is
``ops.cuda_nms.batched_nms``; the kernel wrappers are reached through
their modules (``ops.cuda_nms``, ``ops.cuda_reduce``,
``ops.cuda_labeler``), and no ``pallas_*`` name is exported. As in the
JAX package, ``post_process`` here is the function and hides the module
of that name; code that needs the module imports it by its full name
(``importlib.import_module``).
"""
from .anchors import Anchors, generate_anchor_boxes, get_feat_sizes
from .box_coder import decode_box_outputs, decode_boxes, encode_boxes
from .boxes import (
    clip_boxes_xyxy,
    clip_boxes_yxyx,
    pairwise_iou_xyxy,
    pairwise_iou_yxyx,
    xyxy_to_yxyx,
    yxyx_to_xyxy,
)
from .losses import (
    DetectionLoss,
    box_only_loss_flat,
    class_loss_flat,
    cosine_loss,
    detection_loss_flat,
    detection_loss_levels,
    focal_loss_legacy,
    huber_loss,
    l2_loss,
    levels_to_flat,
    new_focal_loss,
    one_hot,
    smooth_l1_loss,
)
from .nms import (
    batched_nms,
    batched_soft_nms,
    class_offset_boxes,
    nms_fixed,
    soft_nms_fixed,
)
from .ood import energy_score, max_logit_score, msp_score, ood_score
from .post_process import batch_detection, generate_detections, post_process
from .target_assigner import (
    AnchorLabeler,
    LabelResult,
    argmax_match,
    batch_label_anchors,
    label_anchors,
)

__all__ = [
    "AnchorLabeler", "Anchors", "DetectionLoss", "LabelResult",
    "argmax_match", "batch_detection", "batch_label_anchors",
    "batched_nms", "batched_soft_nms", "box_only_loss_flat",
    "class_loss_flat", "class_offset_boxes", "clip_boxes_xyxy",
    "clip_boxes_yxyx", "cosine_loss", "decode_box_outputs", "decode_boxes",
    "detection_loss_flat", "detection_loss_levels", "encode_boxes",
    "energy_score", "focal_loss_legacy", "generate_anchor_boxes",
    "generate_detections", "get_feat_sizes", "huber_loss", "l2_loss",
    "label_anchors", "levels_to_flat", "max_logit_score", "msp_score",
    "new_focal_loss", "nms_fixed", "one_hot", "ood_score",
    "pairwise_iou_xyxy", "pairwise_iou_yxyx", "post_process",
    "smooth_l1_loss", "soft_nms_fixed", "xyxy_to_yxyx", "yxyx_to_xyxy",
]
