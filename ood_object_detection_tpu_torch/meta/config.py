"""Episodic / meta-learning hyperparameters (port of
``ood_object_detection_tpu.meta.config``, copied: the port imports
nothing of the JAX package).

Typed equivalent of the reference infer.py flag set (infer.py:34-98) —
the open-set adaptation knobs: episode composition, projection-network
shape, clustering thresholds, inner/meta optimization.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass
class MetaConfig:
    # episode composition
    n_way: int = 1
    num_sup: int = 25              # support images per episode
    num_qry: int = 25              # query images per episode
    num_zero_images: int = 6       # negative (no-task-object) query images
    meta_batch_size: int = 4       # episodes per meta-update
    img_size: int = 256            # support/projection resolution
    qry_img_size: int = 640        # query resolution
    supp_level_offset: int = 2     # anchors min-level offset for supports
    # augmentation (reference defaults: letterbox-only, infer.py:72-73)
    random_trans: bool = False     # train queries: jitter+flip vs letterbox
    supp_aug: bool = False         # train supports: (0.8, 1.5) jitter+flip

    # projection network
    proj_depth: int = 2
    proj_size: int = 512
    proj_stop_grad: bool = False
    dot_mult: float = 3.0
    dot_add: float = 3.0

    # clustering / losses
    sim_thresh: float = 0.2
    margin: float = 0.0
    loss_mode: str = "separate"    # separate | same | no_conf
    sim_target: str = "max"        # max | avg
    conf_keep_frac: float = 0.125  # static top-k fraction (replaces the
                                   # reference's quantile-adjust loop,
                                   # infer.py:384-394)
    min_level_cells: int = 4       # levels with H<=4 keep all anchors

    # phase schedule / regularizers
    proj_iters: int = 10000
    proj_coeff: float = 30.0
    obj_coeff: float = 0.0001
    proj_reg: float = 0.03

    # inner loop
    steps: int = 1
    inner_lr: float = 0.1
    learn_inner: bool = True       # inner LRs meta-train (enable at
                                   # lr_stage_step); False = frozen
                                   # (requires_grad=False, infer.py:280-282)
    multi_inner: bool = True       # per-layer inner LRs
    only_final: bool = False       # adapt only the predict pointwise params
    inner_thresh_train: bool = False
    # second predict head: support BCE on sep logits, gating on main
    # logits, main predict pw frozen in the inner loop, meta groups
    # predict-sep-at-meta_lr / rest staged (infer.py:203-204, 259-274,
    # 560-564, 663). Must match ModelConfig.separate_head.
    separate_head: bool = False

    # meta optimization
    meta_lr: float = 0.001
    meta_clip: float = 10.0
    optim: str = "adam"            # adam | nesterov
    # meta updates before the staged groups (inner LRs; +class/proj under
    # separate_head) switch from LR 0 to meta_lr — the reference flips
    # them after the 61st step (60 < train_iter < 62, infer.py:815-818)
    lr_stage_step: int = 61
    train_bb: bool = False
    train_fpn: bool = False
    # per-subnet BN mode in the episodic forward (infer.py:323-337):
    # False = that subnet's BNs run in train mode (batch-stat norm)
    freeze_bb_bn: bool = True
    freeze_fpn_bn: bool = True
    freeze_box_bn: bool = True

    # detection eval inside episodes
    nms_thresh: float = 0.3
    max_dets: int = 30

    # --- reference-exact compat modes (PARITY "known deviations") ---
    # Reproduce the reference's cell positional-encoding arithmetic
    # (infer.py:370-371 cat/movedim/reshape: cells in the left half of a
    # row encode (y,y), cells in the right half encode (x-pair, no y))
    # and its feed-row layout [feature | anchor | level | cell]
    # (infer.py:377) — required when porting reference-trained
    # ProjectionNet first-layer weights. Default False = the intended
    # concat(enc_y, enc_x) semantics with layout [feature | level | y |
    # x | anchor].
    ref_pos_enc: bool = False
    # Reproduce the reference's phase-B projection regularizer input: it
    # never recomputes projection-crop activations after phase A, so
    # every phase-B episode re-embeds the LAST phase-A episode's
    # activations (stale) against the CURRENT episode's labels
    # (infer.py:349-359: the proj_feats branch is phase-A-only while the
    # regularizer keeps running). Default False = recompute from the
    # current episode's proj crops.
    ref_stale_proj_activs: bool = False

    def replace(self, **kw) -> "MetaConfig":
        return dataclasses.replace(self, **kw)
