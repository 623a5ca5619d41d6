"""Copy of ``ood_object_detection_tpu.evaluation``."""
from .coco_eval import CocoMeanAP
from .evaluators import (
    CocoEvaluator,
    Evaluator,
    OodEvaluator,
    OpenImagesEvaluator,
    PascalEvaluator,
    PrecisionAtRecallEvaluator,
    WeightedPascalEvaluator,
    create_evaluator,
    default_evaluator_name,
)
from .masks import (
    boxes_to_masks,
    mask_area,
    mask_intersection,
    mask_ioa,
    mask_iou,
    mask_nms,
    multiclass_mask_nms,
    prune_non_overlapping_masks,
)
from .metrics import (
    auroc,
    compute_average_precision,
    compute_cor_loc,
    compute_precision_recall,
    fpr_at_tpr,
)
from .object_detection_evaluation import (
    ObjectDetectionEvaluation,
    PerImageEvaluation,
)
