"""The episodic open-set harness: projection pretraining, the MAML inner
loop and the meta step (port of ``ood_object_detection_tpu.meta``)."""
from .clustering import (
    ClusterResult,
    cluster_pseudo_targets,
    cosine_hinge_loss,
    projection_losses,
    weighted_median,
)
from .config import MetaConfig
from .episode import (
    MetaOptimizer,
    MetaTrainer,
    make_meta_optimizer,
    maml_episode_detections,
    maml_episode_loss,
    maml_episode_ood_scores,
    projection_phase_loss,
    stack_episodes,
)
from .inner_loop import (
    init_inner_lrs,
    inner_adapt,
    sgd_fast_update,
    support_pseudo_loss,
)
from .projection import (
    ANCHOR_ENC,
    CELL_ENC,
    LEVEL_ENC,
    POS_DIM,
    ProjectionGate,
    ProjectionNet,
    build_anchor_features,
    confidence_topk,
    select_confident_anchors,
)
