#!/usr/bin/env python3
"""Drive the PyTorch port's paths on one CUDA card and hold its
hand-written kernels against their plain PyTorch versions.

Predict, train and validate run EfficientDet-D0 at its full width (512 x
512 input, 90 classes, bf16 compute), random weights from a seed (the
meta path, phase 8, its meta model):
  - predict (gaussian soft-NMS, energy OOD, 5000 candidates, 100
    detections): uint8 canvases -> letterbox + normalise -> forward -> K2
    (packed key + energy reduce) -> top-k -> decode -> K1 (NMS) ->
    survivor energy;
  - train (momentum SGD, clip 10, EMA, freeze_bn='backbone', alpha-only
    focal + huber loss): padded ground truth [B, 100] -> K3 (anchor match)
    -> K4 (thresholds, force-match, class and box targets) -> forward with
    train-mode BatchNorm -> loss -> backward -> clipped SGD + EMA;
  - validate (hard NMS, energy OOD, batch 8): JPEGs of a COCO-layout split
    -> PIL decode + letterbox on host threads -> pinned copy to the card
    -> normalise -> forward -> K2 -> top-k -> K1 -> the evaluator thread
    -> mAP;
  - the two training CLIs (f32, as their model configs say): pretrain
    (loader or category stream -> the train step's K3 -> K4 -> val loss
    and the EMA model's detections through K1 -> mAP -> torch
    checkpoints, resumed) and the meta driver (episodes built on a
    prefetch thread, K3 -> K4 -> phase A, phase B -> the adapted head's
    detections and OOD scores through K1).

Phases, each synchronised so that a fault shows where it happened:
  1. the card's name and power limit (nvidia-smi);
  2. build the kernels from csrc/ with nvcc, every source at once;
  3. each kernel vs its plain version on the card: K2 on tied and random
     logits at D0@512, batch 16 and 128, on D0@128 levels at batch 3 (a
     ragged last tile, 9 anchors an image at P7), keys only (energy=False)
     and at 20 and 21 classes (another even class count, and an odd one);
     K1 hard and soft at [16, 5000], [128, 5000], [8, 5000] and [5, 5000]
     with tied scores and an all-zero image, and at [2, 1001], each at the
     wrapper's cluster size and at every cluster size 1, 2, 4, 8; K3 / K4
     at the train path's shapes (49,104 anchors, 100 rows), batch 32 and
     128, with identical rows, a row that overlaps no
     anchor, an all-padding image and a 0.3 / 0.5 ignore band; on D0@128's
     3069 anchors at batch 3 (a ragged split over K3's cluster); with
     every row valid and with only the last row valid; with a row whose
     maximum is tied at two anchors in two CTAs' shares; and with an IoU
     exactly at a threshold (the tie's IoU, and 1.0 for a box equal to an
     anchor);
  4. the predict path answers 3 requests of 16 canvases; K1 and K2 must
     have launched, K2 once a request, the outputs must be finite, of the
     right shapes, with detections, and the plain path on the same batch
     must keep the same candidates;
  5. times of the predict path: K1 / K2 (CUDA events) beside their
     bounds, plain versions and a library call, K1's time a pick at each
     cluster size (also on the batch-16 candidates twice over, batch 32)
     and K2's share of its bytes bound; end to end at batch 16 and 128,
     images/s and the spread of request times over a window; where a
     request's time goes (torch.profiler): device busy time and the
     card's idle share of the request and of each stage, top kernels;
  6. the train path takes 3 steps at batch 32 through create_model(...,
     bench_task='train'), create_train_state and make_train_step; K3 and
     K4 must have launched, the metrics must be finite with positives, the
     parameters, the EMA and the fpn / head BatchNorm statistics must have
     moved and the frozen backbone's must not, and the kernel labels must
     equal the plain labels on the same batch; K3 and K4 must launch once
     a step each;
  7. times of the train path: K3 / K4 beside their bounds and plain
     versions at batch 32 and 128; train steps a second over a window at
     batch 32 and 128 with the peak device memory; and where a step's
     time goes (labeling, forward, loss, backward, optimizer + EMA); the
     labeling stage must issue LABEL_OPS device operations a step, K3's
     cluster launch among them, no more than LABEL_MAX_OPS;
  8. the episodic meta step (meta_path): the D0 meta model (640 px
     queries, 256 px supports, 1 class, f32) and a ProjectionNet with
     MetaConfig defaults; 4 + 8 synthetic episodes rendered on the card
     and labeled by EpisodeBuilder (K3 -> K4), one phase-A meta step and
     two phase-B meta steps (second-order MAML), then the adapted head's
     detections and OOD scores (K1, hard NMS at 0.3, 30 an image); every
     check of the phase (finite metrics, a meta step every 4th episode,
     the class head and ProjectionNet moving while the inner LRs, the
     trunk and every BatchNorm statistic do not, launch counts, kernel
     and plain detections equal); then episodes a second over windows,
     the peak device memory, where a phase-B episode's time goes, and
     K1 / K3 / K4 at the meta shapes beside their bounds.
  9. the offline evaluation entry point (validate_path): a COCO-2017
     layout split of VAL_IMAGES JPEGs written with PIL and a
     reference-named .pth of the seeded D0 (three class biases raised);
     ``validate.main`` over it at D0@512, bf16, energy OOD, batch 8 (a
     partial last batch of 5): 61 images, finite metrics, K1 and K2 once a
     batch; on the same batches the kernel and plain paths keep the same
     candidates and detections; ``--topk-method exact`` and ``approx`` on 2
     batches, their candidate ids equal to the plain versions'; the COCO
     and PASCAL evaluators at AP 1.0 on the ground truth as detections;
     then load / predict / evaluate wall time, images/s, the card's idle
     share over one batch and K1 (hard) / K2 at batch 8 and 5.
 10. the pretrain CLI (pretrain_path): ``train.pretrain.main`` at D0@512,
     90 classes, batch 32, synthetic data, 4 loader threads: 20 steps,
     validation of 2 batches with --eval-map every 10 (a torch.profiler
     trace of steps 10-15), then --resume to step 24, then a 6-step
     --stream run; finite logged losses, val_mAP and the per-category
     dumps at each validation, the checkpoint restoring the final state
     bit for bit, "resumed from step 20", K3 / K4 once a train step and a
     val batch and K1 once a val batch in each run; then img_per_sec, the
     median step by CUDA events around the CLI's step function
     (timed_train_steps), the card's idle share over the traced
     steps, the peak memory, and on a val batch K3 / K4 and K1 against
     their plain versions and timed (pretrain_kernels);
 11. the meta training CLI (meta_driver_path): ``meta.train_driver.main``
     at its defaults (640 / 256 px, 1-way, 25 supports, 25 + 6 queries,
     meta batch 4), 4 phase-A iterations of 12, validation from iteration
     6 with --eval-map and --eval-ood; both phases logged, final_iter 12,
     ood_auroc_gt in [0, 1], the saved meta_params loading into a fresh
     trainer bit for bit, K3 / K4 once an episode built and K1 once a
     detections / OOD call; then episodes/s by phase, of that drive
     (its phase-B blocks are validation episodes) and of 12 training
     iterations with no validation (meta_driver_rate), the peak memory,
     and K1 / K3 / K4 on the last episode against their plain versions
     and timed.
Phases 10 and 11 run with PyTorch's default cuDNN TF32 (the earlier
phases turn it off), as a user runs the CLIs.
Phase 3 also holds K1 at the meta path's [31, 5000] -> 30 (hard, 0.3),
K3 -> K4 at 31 images x 76,725 anchors (6 images all padding) and an
episode's query labels through the kernels against the plain ones, and
K1 at the validate path's [8, 5000] and [5, 5000].

Phase 1 also logs whether PIL imports, whether libjpeg and g++ are found.
Prints a JSON line of per-kernel numbers, the nvidia-smi line, and last
{"ok": true, "device": {...}}. Any failure exits non-zero with no result.

Usage: python3 chip_smoke.py        (one CUDA card; nvcc on PATH or in
                                     $CUDA_HOME/bin, default /usr/local/cuda)
"""
import collections
import contextlib
import ctypes.util
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from types import SimpleNamespace

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from ood_object_detection_tpu_torch.data.device_preproc import (
    batched_letterbox_normalize)
from ood_object_detection_tpu_torch import validate
from ood_object_detection_tpu_torch.data.episodic import (
    EpisodeBuilder, EpisodicDataset, SyntheticEpisodeSource)
from ood_object_detection_tpu_torch.evaluation import (CocoEvaluator,
                                                       PascalEvaluator,
                                                       native)
from ood_object_detection_tpu_torch.config import (
    default_detection_train_config, get_efficientdet_config)
from ood_object_detection_tpu_torch.factory import (create_model,
                                                    create_model_from_config)
from ood_object_detection_tpu_torch.meta import (MetaConfig, MetaTrainer,
                                                 ProjectionNet)
from ood_object_detection_tpu_torch.meta import episode as mep
from ood_object_detection_tpu_torch.meta import train_driver
from ood_object_detection_tpu_torch.meta.inner_loop import (class_head,
                                                            inner_adapt)
from ood_object_detection_tpu_torch.ops import (cuda_build, cuda_labeler,
                                                cuda_nms, cuda_reduce)
from ood_object_detection_tpu_torch.ops import post_process as pp
from ood_object_detection_tpu_torch.ops.anchors import Anchors
from ood_object_detection_tpu_torch.ops.boxes import pairwise_iou_yxyx
from ood_object_detection_tpu_torch.ops.losses import detection_loss_nhwc
from ood_object_detection_tpu_torch.ops.nms import batched_nms_plain
from ood_object_detection_tpu_torch.ops.target_assigner import (
    batch_label_anchors)
from ood_object_detection_tpu_torch.train import (CheckpointManager,
                                                  create_train_state,
                                                  make_train_step, pretrain)
from ood_object_detection_tpu_torch.train import train_state as train_state_mod
from ood_object_detection_tpu_torch.train.train_state import (
    apply_gradients, detection_loss)
from ood_object_detection_tpu_torch.utils import StepTimer, from_jax

# H100 SXM peaks (NVIDIA data sheet, 700 W): device memory, and the f32
# rate outside the tensor cores. The data sheet's 67 TFLOP/s counts a
# fused multiply-add as two operations; the kernels run compares, min/max,
# adds and multiplies, one operation an instruction, so half of it.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12 / 2
NUM_CLASSES = 90
BATCH = 16
TRAIN_BATCH = 32
MAX_ROWS = 100       # padded ground-truth rows (max_instances_per_image)
IMG = 512
WINDOW_S = 2.5       # end-to-end timing window at each batch
PROFILE_REPS = 10    # calls in each profiler window
TRAIN_PROFILE_REPS = 3
# calls in the labeling stage's profiler window: a window of 3 calls (under
# a millisecond) kept a quarter of the stage's device operations, or none
LABEL_PROFILE_REPS = 30
# f32 operations of K3 for each valid (row, anchor) pair: 2 min, 2 max, 2
# sub and 2 clamp of the two overlaps, their product and its zero test;
# and for each pair whose boxes meet, MATCH_OPS_PER_MEET more: the add and
# the subtract of the union, the division (counted as one), the running-max
# compare, the order-preserving key (2) and its compare. The flat
# yardstick charges every valid pair with the sum, as if every pair met.
MATCH_OPS_PER_PAIR = 10
MATCH_OPS_PER_MEET = 7
# device operations the labeling stage issues a step: the valid mask, K3,
# the zeroing of K4's positive counts and K4; and the most it may issue
LABEL_OPS = 4
LABEL_MAX_OPS = 6
# the meta path: phase-A and phase-B episodes (one and two meta steps of
# MetaConfig's meta_batch_size 4), categories of the synthetic episodes,
# calls in a meta profiler window
META_EPISODES = (4, 8)
META_CATS = 6
META_PROFILE_REPS = 3
# the validate path: images of the COCO-layout split (a partial last batch
# of 5 at batch 8), COCO's usual image sizes (h, w), its categories
VAL_IMAGES = 61
VAL_BATCH = 8
COCO_SIZES = ((480, 640), (640, 480), (427, 640), (375, 500), (612, 612))
COCO_CATS = ((1, "person"), (3, "car"), (18, "dog"))
# the card as nvidia-smi names it (name, power limit), set by main(); the
# meta path's measurements print it on their lines
CARD = "not read"
# CUDA runtime calls that put an operation on the card (profiler names)
RUNTIME_OPS = ("cudaLaunch", "cudaMemset", "cudaMemcpy")
REPO_KERNELS = {
    "K1": ("ood_object_detection_tpu_torch/csrc/nms.cu",
           "ood_object_detection_tpu/ops/pallas_nms.py:77"),
    "K2": ("ood_object_detection_tpu_torch/csrc/key_reduce.cu",
           "ood_object_detection_tpu/ops/pallas_reduce.py:79"),
    "K3": ("ood_object_detection_tpu_torch/csrc/label_match.cu",
           "ood_object_detection_tpu/ops/pallas_labeler.py:146"),
    "K4": ("ood_object_detection_tpu_torch/csrc/label_targets.cu",
           "ood_object_detection_tpu/ops/pallas_labeler.py:201"),
}


def log(*args):
    print(*args, flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def sync():
    torch.cuda.synchronize()


def cuda_ms(fn, iters, warmup=2):
    """Mean device time of fn() over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    sync()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    sync()
    return start.elapsed_time(end) / iters


def level_shapes(batch, img=IMG):
    """D0 class-head output shapes [B, H, W, 9*C] of levels P3..P7."""
    return [(batch, img >> lvl, img >> lvl, 9 * NUM_CLASSES)
            for lvl in range(3, 8)]


def random_logits(batch, gen, img=IMG):
    """bf16 logits, normal around the focal prior."""
    return [(torch.randn(shape, generator=gen, device="cuda") * 2.0 - 3.0
             ).to(torch.bfloat16) for shape in level_shapes(batch, img)]


def tied_logits(batch, gen, img=IMG):
    """bf16 logits on a coarse grid (many tied values and packed keys);
    one anchor per level with all classes equal."""
    levels = []
    for shape in level_shapes(batch, img):
        x = torch.randn(shape, generator=gen, device="cuda") * 1.5 - 3.0
        x = (torch.round(x * 4) / 4 + 0.0).to(torch.bfloat16)
        x[0, 0, 0, :NUM_CLASSES] = 0.5
        levels.append(x)
    return levels


def random_nms_inputs(batch, n, gen):
    x1 = torch.rand((batch, n), generator=gen, device="cuda") * 300
    y1 = torch.rand((batch, n), generator=gen, device="cuda") * 300
    w = torch.rand((batch, n), generator=gen, device="cuda") * 55 + 5
    h = torch.rand((batch, n), generator=gen, device="cuda") * 55 + 5
    boxes = torch.stack([x1, y1, x1 + w, y1 + h], dim=-1).contiguous()
    scores = torch.rand((batch, n), generator=gen, device="cuda")
    scores = torch.round(scores * 8) / 8               # exact ties
    scores[1] = 0.0                                    # an all-zero row
    return boxes, scores


def k2_compare(levels, energy=True, num_classes=NUM_CLASSES):
    """K2 against its plain version: the key bit for bit, the energy to
    rtol 1e-5 / atol 1e-5 (f32 summation order). Returns the energy's max
    abs error (0 for keys only)."""
    key, en = cuda_reduce.key_energy_reduce(levels, num_classes, energy)
    key_p, en_p = cuda_reduce.key_energy_reduce_plain(
        levels, num_classes, energy)
    sync()
    check(torch.equal(key, key_p), "K2 key differs from the plain version")
    if not energy:
        check(en is None, "K2 returned an energy it was not asked for")
        return 0.0
    check(torch.allclose(en, en_p, rtol=1e-5, atol=1e-5),
          "K2 energy differs from the plain version beyond rtol 1e-5")
    return float((en - en_p).abs().max())


def k1_compare(boxes, scores, soft, cluster=None, max_out=100):
    """K1 (at a forced cluster size, or the wrapper's choice) against its
    plain version: keep indices equal, scores to rtol 1e-6 (hard) or 1e-4
    (soft). Returns the scores' max abs error."""
    kw = dict(max_out=max_out, iou_threshold=0.3, soft=soft)
    keep, kept = cuda_nms.batched_nms(boxes, scores, cluster=cluster, **kw)
    keep_p, kept_p = batched_nms_plain(boxes, scores, **kw)
    sync()
    check(torch.equal(keep, keep_p),
          f"K1 keep indices differ (soft={soft}, cluster={cluster}) from "
          "the plain version")
    rtol = 1e-4 if soft else 1e-6
    check(torch.allclose(kept, kept_p, rtol=rtol, atol=0),
          f"K1 kept scores differ beyond rtol {rtol} (cluster={cluster})")
    return float((kept - kept_p).abs().max())


def canvases(batch, gen):
    """uint8 canvases of 512 x 512, each image's valid (h, w) in [256, 512)
    (the JAX package's predict_bench inputs, bench.py:100-104)."""
    imgs = torch.randint(0, 256, (batch, IMG, IMG, 3), generator=gen,
                         device="cuda", dtype=torch.uint8)
    hw = torch.randint(IMG // 2, IMG, (batch, 2), generator=gen,
                       device="cuda").cpu()
    return imgs, hw


def nms_bound_ms(keep, n, soft):
    """Least time for the NMS on these inputs: its bytes (boxes + scores in,
    picks out) over the memory rate, or its operations over the f32 rate:
    each iteration that runs (the picks made, and the one that finds no
    positive score) scans and updates all n candidates, 15 operations a
    candidate for hard NMS (argmax step, IoU, compare), 20 for soft.
    Neither counts the chain of dependent picks, which is what sets the
    kernel's time (see kernel_times' per-pick latency)."""
    b, max_out = keep.shape
    live = (keep >= 0).sum(dim=1)
    iterations = int(torch.clamp(live + 1, max=max_out).sum())
    ops = iterations * n * (20 if soft else 15)
    nbytes = b * n * (16 + 4) + b * max_out * 8
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else \
        "operations"


def reduce_bound_ms(levels):
    """Least time for K2: every logit read once, keys and energies written
    once, against about 9 operations a logit (key: 5, energy: 4)."""
    elements = sum(lvl.numel() for lvl in levels)
    anchors = elements // NUM_CLASSES
    nbytes = elements * 2 + anchors * 8
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, elements * 9 / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else \
        "operations"


def ground_truth(batch, gen, cases=False, img=IMG, n=16):
    """Padded ground truth as the JAX package's train_bench makes it
    (bench.py:183-194): n = 16 boxes of 16-64 px an image, classes 1-89,
    padded to MAX_ROWS rows of class -1. With ``cases``: image 0 has two
    identical rows and a row that overlaps no anchor, image 1 is all
    padding."""
    yx = torch.rand((batch, n, 2), generator=gen, device="cuda") * (img - 64)
    hw = torch.rand((batch, n, 2), generator=gen, device="cuda") * 48 + 16
    boxes = torch.zeros((batch, MAX_ROWS, 4), device="cuda")
    boxes[:, :n] = torch.cat([yx, yx + hw], dim=-1)
    cls = torch.full((batch, MAX_ROWS), -1, dtype=torch.int32, device="cuda")
    cls[:, :n] = torch.randint(1, 90, (batch, n), generator=gen,
                               device="cuda", dtype=torch.int32)
    if cases:
        boxes[0, 1] = boxes[0, 0]
        boxes[0, 2] = torch.tensor([4000.0, 4000.0, 4010.0, 4010.0])
        cls[1] = -1
    return boxes, cls


def label_compare(anchor_boxes, boxes, cls, unmatched, matched=0.5,
                  exact=False):
    """K3 and K4 against their plain versions on the same inputs (K4's on
    K3's outputs): all bit for bit but the box targets (rtol 1e-5, atol
    1e-6; bit for bit too with ``exact``). Returns (K3's max abs IoU
    error, K4's max abs box error, the codes, K3's outputs)."""
    valid = cls > -1
    k3 = cuda_labeler.batch_match(anchor_boxes, boxes, valid)
    p3 = cuda_labeler.batch_match_plain(anchor_boxes, boxes, valid)
    sync()
    for name, a, b in zip(("IoU values", "rows", "best anchors"), k3, p3):
        check(torch.equal(a, b), f"K3 {name} differ from the plain version")
    err_k3 = float((k3[0] - p3[0]).abs().max())
    args = (anchor_boxes, boxes, cls, valid, *k3, matched, unmatched)
    codes, cls_t, box_t, pos = cuda_labeler.batch_codes_targets(*args)
    codes_p, cls_p, box_p, pos_p = cuda_labeler.batch_codes_targets_plain(
        *args)
    sync()
    check(torch.equal(codes, codes_p), "K4 match codes differ")
    check(torch.equal(cls_t, cls_p), "K4 class targets differ")
    check(torch.equal(pos, pos_p), "K4 positive counts differ")
    check(torch.allclose(box_t, box_p, rtol=1e-5, atol=1e-6),
          "K4 box targets differ beyond rtol 1e-5 / atol 1e-6")
    check(not exact or torch.equal(box_t, box_p),
          "K4 box targets differ from the plain version's bits")
    return err_k3, float((box_t - box_p).abs().max()), codes, k3


def cross_cta_tie(anchor_boxes):
    """A ground-truth box whose IoU is one f32 value at two anchors of
    equal size (integer corners, one grid row) that lie in the shares of
    two CTAs of K3's cluster, and is the row's maximum there and nowhere
    else: (box [4], lower anchor, higher anchor, the IoU). Found on the
    host and checked with the plain version's IoU."""
    boxes = anchor_boxes.cpu()
    exact = (boxes == boxes.round()).all(dim=1)
    width = boxes[:, 3] - boxes[:, 1]
    for lo, hi in cuda_labeler.match_shares(boxes.shape[0])[1:]:
        for j in range(lo, min(hi, lo + 64)):
            y1, x1, y2, x2 = boxes[j].tolist()
            left = (exact[:lo] & (boxes[:lo, 0] == y1) & (boxes[:lo, 2] == y2)
                    & (width[:lo] == x2 - x1) & (boxes[:lo, 1] < x1)
                    & (boxes[:lo, 3] > x1))
            if not exact[j] or not bool(left.any()):
                continue
            i = int(left.nonzero().max())
            gt = torch.tensor([y1, float(boxes[i, 1]), y2, x2])
            iou = pairwise_iou_yxyx(gt[None], boxes)[0]
            top = float(iou.max())
            if float(iou[i]) == float(iou[j]) == top and \
                    int((iou == top).sum()) == 2:
                return gt.to(anchor_boxes.device), i, j, top
    raise AssertionError("no anchor pair for a tie across K3's CTAs")


def label_hazards(anchor_boxes, gen):
    """Phase 3's labeler cases beyond the train path's batches, each K3 /
    K4 against the plain versions (label_compare): D0@128 at batch 3, a
    ragged split of 3069 anchors over K3's cluster; every row valid; only
    the last row valid; a row tied at two anchors in two CTAs' shares; an
    IoU exactly at the matched threshold."""
    anchors128 = torch.from_numpy(Anchors.from_config(
        get_efficientdet_config("efficientdet_d0"), img_size=128).boxes
    ).cuda()
    shares = cuda_labeler.match_shares(anchors128.shape[0])
    boxes, cls = ground_truth(3, gen, cases=True, img=128)
    for unmatched in (0.5, 0.3):
        _, _, codes, (_, _, best) = label_compare(anchors128, boxes, cls,
                                                  unmatched)
        check(int(best[0, 0]) == int(best[0, 1]) and int(best[0, 2]) == 0
              and bool((codes[1] == -1).all()),
              "D0@128: identical rows, the far row or the padded image")
    log(f"[3] K3 / K4 D0@128 [3, {MAX_ROWS}] x {anchors128.shape[0]} anchors "
        f"(shares {shares[0][1] - shares[0][0]} .. "
        f"{shares[-1][1] - shares[-1][0]}): equal")

    boxes, cls = ground_truth(8, gen, n=MAX_ROWS)
    label_compare(anchor_boxes, boxes, cls, 0.3)
    cls[:, :-1] = -1
    _, _, codes, (vals, rows, best) = label_compare(anchor_boxes, boxes, cls,
                                                    0.3)
    check(bool((rows == MAX_ROWS - 1).all()) and bool((best[:, :-1] == 0)
                                                      .all()),
          "only the last row valid: every anchor's row, padded rows' anchor")
    log(f"[3] K3 / K4 every row valid and only the last row valid [8, "
        f"{MAX_ROWS}]: equal")

    gt, i, j, tie = cross_cta_tie(anchor_boxes)
    log(f"[3] tie across K3's CTAs: anchors {i} and {j} both reach the row "
        f"maximum IoU {tie!r} with box {gt.tolist()} (plain IoU)")
    boxes, cls = ground_truth(2, gen)
    boxes[0], cls[0] = 0.0, -1
    boxes[0, 0], cls[0, 0] = gt, 7
    k = anchor_boxes.shape[0] // 2 + 5            # a box equal to an anchor
    boxes[1, 0] = anchor_boxes[k]
    above = float(torch.tensor(tie).nextafter(torch.tensor(2.0)))
    for matched, code_j in ((tie, 0), (above, -1)):
        _, _, codes, (vals, _, best) = label_compare(anchor_boxes, boxes, cls,
                                                     matched, matched)
        check(int(best[0, 0]) == i and float(vals[0, j]) == tie
              and int(codes[0, i]) == 0 and int(codes[0, j]) == code_j,
              f"tie across CTAs at threshold {matched!r}: the lower anchor "
              "must be the row's, the higher one matched only at the IoU")
    _, _, codes, (vals, _, best) = label_compare(anchor_boxes, boxes, cls,
                                                 1.0, 1.0)
    check(float(vals[1, k]) == 1.0 and int(codes[1, k]) == 0
          and int(best[1, 0]) == k, "IoU 1.0 at threshold 1.0")
    log("[3] K3 / K4 tie across CTAs and IoU at the threshold (the tie's "
        "IoU, the next f32 above it, 1.0): equal")


def meeting_pairs(anchor_boxes, gt_boxes, valid):
    """How many valid (row, anchor) pairs have boxes that meet (a nonzero
    intersection, as K3 tests it), one image at a time."""
    total = 0
    for boxes, ok in zip(gt_boxes, valid):
        g = boxes[ok][:, None]
        ih = torch.clamp(torch.minimum(g[..., 2], anchor_boxes[:, 2])
                         - torch.maximum(g[..., 0], anchor_boxes[:, 0]),
                         min=0.0)
        iw = torch.clamp(torch.minimum(g[..., 3], anchor_boxes[:, 3])
                         - torch.maximum(g[..., 1], anchor_boxes[:, 1]),
                         min=0.0)
        total += int((ih * iw != 0).sum())
    return total


def match_bound_ms(anchor_boxes, gt_boxes, valid):
    """Least time for K3 on these inputs: MATCH_OPS_PER_PAIR f32 operations
    for each valid (row, anchor) pair (a padded row costs the kernel no
    IoU) and MATCH_OPS_PER_MEET more for each such pair whose boxes meet,
    against its bytes (anchors and rows in; per-anchor value and row,
    per-row anchor out). Also the flat yardstick, MATCH_OPS_PER_PAIR +
    MATCH_OPS_PER_MEET for every valid pair, in ms."""
    b, m = valid.shape
    a = anchor_boxes.shape[0]
    pairs = int(valid.sum()) * a
    ops = pairs * MATCH_OPS_PER_PAIR + meeting_pairs(
        anchor_boxes, gt_boxes, valid) * MATCH_OPS_PER_MEET
    nbytes = a * 16 + b * m * 17 + b * a * 8 + b * m * 4
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    every = pairs * (MATCH_OPS_PER_PAIR + MATCH_OPS_PER_MEET) / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else \
        "operations", every * 1e3


def targets_bound_ms(codes, m):
    """Least time for K4 (thresholds, force-match and targets from K3's
    outputs): each anchor's IoU and row read once (8 B), its code, class
    and box written once (24 B), the anchors read once and the rows (box,
    class, valid, best anchor: 25 B) once; against about 4 operations an
    anchor (two thresholds, the claim, the count) and 20 a positive (the
    encode). A codes-in K4 would move only the codes in and the targets
    out."""
    b, a = codes.shape
    nbytes = b * a * (8 + 24) + a * 16 + b * m * 25
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = (b * a * 4 + int((codes >= 0).sum()) * 20) / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else \
        "operations"


def label_kernel_times(anchor_boxes, boxes, cls, tag="[7]"):
    """K3 and K4 (CUDA events, after warm-up) beside their bounds and their
    plain versions on the given inputs (the train path's, or the meta
    path's with ``tag`` "[8]"); no single PyTorch call computes either, so
    no library time."""
    valid = cls > -1
    batch = cls.shape[0]
    codes = batch_label_anchors(anchor_boxes, boxes, cls).matches
    k3_bound, k3_by, k3_every = match_bound_ms(anchor_boxes, boxes, valid)
    k4_bound, k4_by = targets_bound_ms(codes, cls.shape[1])
    k3_out = cuda_labeler.batch_match(anchor_boxes, boxes, valid)
    k4_args = (anchor_boxes, boxes, cls, valid, *k3_out, 0.5, 0.5)
    k3 = dict(
        ms=cuda_ms(lambda: cuda_labeler.batch_match(anchor_boxes, boxes,
                                                    valid), 50),
        plain_ms=cuda_ms(lambda: cuda_labeler.batch_match_plain(
            anchor_boxes, boxes, valid), 3),
        bound_ms=k3_bound, bound_by=k3_by, library_ms=None)
    k4 = dict(
        ms=cuda_ms(lambda: cuda_labeler.batch_codes_targets(*k4_args), 50),
        plain_ms=cuda_ms(lambda: cuda_labeler.batch_codes_targets_plain(
            *k4_args), 10),
        bound_ms=k4_bound, bound_by=k4_by, library_ms=None)
    for name, t in (("K3", k3), ("K4", k4)):
        log(f"{tag} {name} B={batch}: {t['ms']:.4f} ms, plain "
            f"{t['plain_ms']:.3f} ms, bound {t['bound_ms']:.5f} ms "
            f"({t['bound_by']}), {100 * t['bound_ms'] / t['ms']:.1f} % of "
            "it reached")
    log(f"{tag} K3 B={batch}: {meeting_pairs(anchor_boxes, boxes, valid)} of "
        f"{int(valid.sum()) * anchor_boxes.shape[0]} valid pairs meet; bound "
        f"by the flat yardstick ({MATCH_OPS_PER_PAIR + MATCH_OPS_PER_MEET} "
        f"operations every valid pair) {k3_every:.5f} ms, "
        f"{100 * k3_every / k3['ms']:.1f} % of it reached")
    return {"K3": k3, "K4": k4}


def train_batch(batch, gen):
    """Normal images [B, 512, 512, 3] f32 and their padded ground truth."""
    boxes, cls = ground_truth(batch, gen)
    image = torch.randn((batch, IMG, IMG, 3), generator=gen, device="cuda")
    return {"image": image, "bbox": boxes, "cls": cls}


def train_path(gen):
    """Phase 6: 3 train steps at TRAIN_BATCH through the user's entry
    points, with every check of the phase. Returns (model, state, step,
    K3 / K4 launches, the labels' max abs box error)."""
    bench = create_model("efficientdet_d0", bench_task="train",
                         num_classes=NUM_CLASSES, compute_dtype="bfloat16",
                         seed=0, device="cuda")
    tcfg = default_detection_train_config()
    state, tx = create_train_state(bench, tcfg)
    step = make_train_step(bench, tx, bench.anchors, tcfg,
                           freeze_bn="backbone")
    model = bench.model
    before = {n: t.detach().clone() for n, t in
              list(model.named_parameters()) + list(model.named_buffers())}
    ema_before = {n: e.clone() for n, e in state.ema_params.items()}
    batches = [train_batch(TRAIN_BATCH, gen) for _ in range(3)]
    sync()
    reset_launches()
    metrics = []
    for batch in batches:
        state, m = step(state, batch)
        metrics.append(m)
    sync()
    launches = {"K3": cuda_labeler.batch_match.launches,
                "K4": cuda_labeler.batch_codes_targets.launches}
    log(f"[6] train path: 3 steps x {TRAIN_BATCH} images, launches "
        f"{launches}")
    check(launches["K3"] > 0 and launches["K4"] > 0,
          f"a kernel of the train path never launched: {launches}")
    check(launches["K3"] == launches["K4"] == len(batches),
          f"K3 and K4 must launch once a step: {launches} for "
          f"{len(batches)} steps")
    for i, m in enumerate(metrics):
        values = {k: float(v) for k, v in m.items()}
        log(f"[6] step {i + 1}: {values}")
        check(all(math.isfinite(v) for v in values.values()),
              f"non-finite metrics at step {i + 1}")
        check(values["num_positives"] > 0, f"no positives at step {i + 1}")
    check(state.step == 3, "the step counter did not reach 3")

    now = model.state_dict()
    moved = {n for n, t in before.items() if not torch.equal(now[n], t)}
    params = [n for n, _ in model.named_parameters()]
    stats = [n for n in before if n.endswith(("running_mean", "running_var"))]
    head_stats = [n for n in stats if not n.startswith("backbone.")]
    # a parameter with no gradient (a box-head BatchNorm of a level with no
    # positives) keeps its value under momentum SGD, as under optax
    for group in ("backbone.", "fpn.", "class_net.", "box_net."):
        check(any(n in moved for n in params if n.startswith(group)),
              f"no parameter of {group[:-1]} moved")
    check(any(not torch.equal(e, ema_before[n])
              for n, e in state.ema_params.items()), "the EMA did not move")
    # every running variance moves; a running mean may stay at 0 where the
    # batch mean is exactly 0 (a map of two samples normalised to +-1)
    check(moved.issuperset(n for n in head_stats if n.endswith("_var"))
          and len(moved.intersection(head_stats)) > len(head_stats) // 2,
          "fpn / head BatchNorm statistics did not move")
    check(not moved.intersection(set(stats) - set(head_stats)),
          "frozen backbone BatchNorm statistics moved")
    log(f"[6] {len(moved.intersection(params))} of {len(params)} "
        f"parameters, the EMA and {len(moved.intersection(head_stats))} of "
        f"{len(head_stats)} fpn / head BatchNorm statistics moved; the "
        f"backbone's stayed")

    # the kernel and plain labels on the last batch
    batch = batches[-1]
    labels = batch_label_anchors(bench.anchor_boxes, batch["bbox"],
                                 batch["cls"])
    plain = batch_label_anchors(bench.anchor_boxes, batch["bbox"],
                                batch["cls"], kernels=False)
    sync()
    for f in ("matches", "cls_targets", "num_positives"):
        check(torch.equal(getattr(labels, f), getattr(plain, f)),
              f"train batch: kernel and plain {f} differ")
    check(torch.allclose(labels.box_targets, plain.box_targets, rtol=1e-5,
                         atol=1e-6), "train batch: box targets differ")
    err = float((labels.box_targets - plain.box_targets).abs().max())
    log(f"[6] kernel and plain labels equal on the train batch "
        f"({int(labels.num_positives.sum())} positives), box max abs err "
        f"{err:.3g}")
    return bench, state, step, tx, tcfg, launches, err


def train_throughput(bench, state, step, tx, tcfg, batch_size, gen):
    """Train steps over a WINDOW_S window at ``batch_size`` (each ending in
    a synchronise): images/s, the median / least / most step time, the
    peak device memory; then where a step's time goes (profile_window of
    the whole step and of its stages) and its top device kernels."""
    batch = train_batch(batch_size, gen)
    torch.cuda.reset_peak_memory_stats()
    step(state, batch)
    sync()
    times = []
    start = time.perf_counter()
    while time.perf_counter() - start < WINDOW_S:
        t0 = time.perf_counter()
        step(state, batch)
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    times.sort()
    log(f"[7] train B={batch_size}: {batch_size * len(times) * 1e3 / sum(times)}"
        f" images/s over {len(times)} steps; step ms median "
        f"{times[len(times) // 2]}, min {times[0]}, max {times[-1]}; peak "
        f"memory {peak:.2f} GiB")

    model = bench.model
    anchors = bench.anchor_boxes

    def label():
        return batch_label_anchors(anchors, batch["bbox"], batch["cls"])
    labels = label()

    def forward():
        model.train_bn("backbone")
        return model(batch["image"])

    def loss():
        return detection_loss(model.config, *forward(), labels)[0]

    def backward():
        tx.zero_grad()
        loss().backward()

    stages = {"step": lambda: step(state, batch), "labeling": label,
              "forward": forward, "forward+loss": loss,
              "forward+loss+backward": backward,
              "optimizer+EMA": lambda: apply_gradients(state, tx, tcfg)}
    top = collections.Counter()
    for name, fn in stages.items():
        reps = LABEL_PROFILE_REPS if name == "labeling" else \
            TRAIN_PROFILE_REPS
        numbers, device, issued = profile_window(fn, reps)
        log(f"[7] profile train B={batch_size} {name}: " + ", ".join(
            f"{k} {v}" for k, v in numbers.items()))
        if name == "labeling":
            # counted from the host's CUDA runtime calls: the profiler has
            # dropped part of a short window's device events
            log(f"[7] labeling B={batch_size}: runtime calls a step "
                + ", ".join(f"{k} {v / reps}" for k, v in issued.items()))
            cluster = sum(v for k, v in issued.items()
                          if k.startswith("cudaLaunchKernelEx"))
            check(numbers["issued"] == LABEL_OPS <= LABEL_MAX_OPS
                  and cluster == reps,
                  f"the labeling stage issued {numbers['issued']} device "
                  f"operations a step ({dict(issued)} over {reps} steps), "
                  f"not the mask, K3's cluster launch, a memset and K4")
            kernels = collections.defaultdict(list)
            for e in device:
                kernels[e.name[:60]].append(
                    (e.time_range.end - e.time_range.start) / 1e3)
            for kname, ms in kernels.items():
                log(f"[7] labeling B={batch_size} device op: "
                    f"{len(ms) / reps} a step, "
                    f"{sum(ms) / len(ms):.4f} ms each, {kname}")
        if name == "step":
            for e in device:
                top[e.name[:80]] += (e.time_range.end - e.time_range.start
                                     ) / 1e3 / TRAIN_PROFILE_REPS
    for name, ms in top.most_common(12):
        log(f"[7] top kernel train B={batch_size}: {ms:.4f} ms {name}")


def meta_kernel_cases(gen):
    """Phase 3's cases at the meta path's shapes: K1 on [31, 5000] -> 30,
    hard at 0.3, at every cluster size; K3 -> K4 on 31 query images of
    640 px (76,725 anchors, 100 rows, the last 6 images all padding), bit
    for bit; and an episode's query labels from EpisodeBuilder through the
    kernels and through the plain versions, equal."""
    mc = MetaConfig()
    q = mc.num_qry + mc.num_zero_images
    boxes, scores = random_nms_inputs(q, 5000, gen)
    errs = [k1_compare(boxes, scores, False, cluster=c, max_out=mc.max_dets)
            for c in cuda_nms.CLUSTER_SIZES]
    log(f"[3] K1 hard [{q}, 5000] -> {mc.max_dets}: keep equal at clusters "
        f"{cuda_nms.CLUSTER_SIZES}, score max abs err {max(errs):.3g}")
    cfg = get_efficientdet_config("efficientdet_d0", num_classes=1,
                                  image_size=(mc.qry_img_size,) * 2)
    anchors = torch.from_numpy(Anchors.from_config(cfg).boxes).cuda()
    boxes, cls = ground_truth(q, gen, img=mc.qry_img_size)
    cls[mc.num_qry:] = -1
    _, err, codes, _ = label_compare(anchors, boxes, cls, 0.5, exact=True)
    check(bool((codes[mc.num_qry:] == -1).all()), "padded images matched")
    log(f"[3] K3 / K4 [{q}, {MAX_ROWS}] x {anchors.shape[0]} anchors, last "
        f"{mc.num_zero_images} images all padding: bit-exact")
    args = synthetic_episode(mc, np.random.default_rng(1), gen, torch.from_numpy(
        np.random.default_rng(7).integers(40, 255, (META_CATS + 1, 3))
        .astype(np.uint8)).cuda(), "cuda")
    got = EpisodeBuilder(cfg, mc, device="cuda").build(*args)
    want = EpisodeBuilder(cfg, mc, device="cuda", kernels=False).build(*args)
    sync()
    for key in ("qry_cls", "qry_box", "qry_num_positives", "proj_cls"):
        check(torch.equal(got[key], want[key]),
              f"EpisodeBuilder {key}: kernels and plain versions differ")
    log(f"[3] EpisodeBuilder query labels through K3 / K4 equal the plain "
        f"versions' ({int(got['qry_num_positives'].sum())} positives)")


def host_facts():
    """Facts the host-data slice needs about this machine: whether PIL
    imports, where libjpeg is, where g++ is (None where absent)."""
    try:
        import PIL
        pil = PIL.__version__
    except ImportError:
        pil = None
    return pil, ctypes.util.find_library("jpeg"), shutil.which("g++")


def synthetic_boxes(rng, n, size):
    """n yxyx boxes as SyntheticEpisodeSource._render draws them: corner in
    [0, 0.6 size), sides in [0.2, 0.4) size, clipped at size - 1."""
    y0, x0 = rng.uniform(0, size * 0.6, (2, n))
    bh, bw = rng.uniform(size * 0.2, size * 0.4, (2, n))
    return np.stack([y0, x0, np.minimum(y0 + bh, size - 1),
                     np.minimum(x0 + bw, size - 1)], 1).astype(np.float32)


def render(rng, gen, size, cats_per_image, colors, device):
    """uint8 canvases [N, size, size, 3] on ``device``: noise in [0, 80)
    and, for each category of an image's list, 1-3 boxes filled with the
    category's color (SyntheticEpisodeSource._render, drawn on the card).
    Returns (canvases, per image (boxes [n, 4] yxyx, classes [n]))."""
    imgs = torch.randint(0, 80, (len(cats_per_image), size, size, 3),
                         generator=gen, device=device, dtype=torch.uint8)
    gt = []
    for i, cats in enumerate(cats_per_image):
        boxes, classes = [np.zeros((0, 4), np.float32)], []
        for c in cats:
            b = synthetic_boxes(rng, int(rng.integers(1, 4)), size)
            for y0, x0, y1, x1 in b.astype(int):
                imgs[i, y0:y1, x0:x1] = colors[c]
            boxes.append(b)
            classes += [c] * len(b)
        gt.append((np.concatenate(boxes), np.asarray(classes, np.int32)))
    return imgs, gt


def synthetic_episode(mc, rng, gen, colors, dev):
    """The ``EpisodeBuilder.build`` arguments of one n-way-1 episode as
    EpisodicDataset composes it, rendered on ``dev``: num_sup supports of
    the task category; num_qry queries with task boxes (class 1) and 0-2
    distractor categories, plus num_zero_images with distractors only (no
    ground truth); num_qry projection crops labeled with every category."""
    task = int(rng.integers(1, META_CATS + 1))
    others = [c for c in range(1, META_CATS + 1) if c != task]

    def distractors(least=0):
        return [int(c) for c in rng.choice(
            others, int(rng.integers(least, 3)), replace=False)]
    supp, _ = render(rng, gen, mc.img_size, [[task]] * mc.num_sup, colors,
                     dev)
    qry, qry_gt = render(rng, gen, mc.qry_img_size,
                         [[task] + distractors() for _ in range(mc.num_qry)]
                         + [distractors(1)
                            for _ in range(mc.num_zero_images)], colors, dev)
    proj, proj_gt = render(rng, gen, mc.img_size,
                           [[task] + distractors()
                            for _ in range(mc.n_way * mc.num_qry)], colors,
                           dev)
    qry_annos = [dict(bbox=b[c == task],
                      cls=np.ones(int((c == task).sum()), np.int32))
                 for b, c in qry_gt]
    proj_annos = [dict(bbox=b, cls=c) for b, c in proj_gt]
    return (supp, [np.ones(1, np.float32)] * mc.num_sup, qry, qry_annos,
            proj, proj_annos, task, [task], False)


def _snapshot(tree):
    return {t: {n: v.detach().clone() for n, v in d.items()}
            for t, d in tree.items()}


def _moved(before, after, tree):
    return any(not torch.equal(before[tree][n], v.detach())
               for n, v in after[tree].items())


def meta_setup(gen, device="cuda", meta_cfg=None, **model_overrides):
    """The meta path's objects through the user's entry points: the D0
    meta model (one class at the query resolution, f32, seed 0, class bias
    raised by 2 so that detections exist), a ProjectionNet (seed 1), an
    EpisodeBuilder and a MetaTrainer with ``meta_cfg`` (MetaConfig
    defaults), and the categories' colors."""
    meta_cfg = meta_cfg or MetaConfig()
    size = meta_cfg.qry_img_size
    model = create_model("efficientdet_d0", num_classes=1, seed=0,
                         device=device, image_size=(size, size),
                         **model_overrides)
    with torch.no_grad():
        model.class_net.predict_bias().add_(2.0)
    proj = ProjectionNet(model.config.fpn_channels, meta_cfg.proj_size,
                         meta_cfg.proj_depth)
    proj.init_weights(torch.Generator().manual_seed(1))
    builder = EpisodeBuilder(model.config, meta_cfg, device=device)
    trainer = MetaTrainer(model, proj, meta_cfg, model.config,
                          builder.proj_level_sizes, device=device)
    colors = torch.from_numpy(np.random.default_rng(7).integers(
        40, 255, (META_CATS + 1, 3)).astype(np.uint8)).to(device)
    return trainer, builder, colors


def meta_path(trainer, builder, colors, gen, episodes=META_EPISODES):
    """Phase 8: build ``sum(episodes)`` synthetic episodes, run them through
    ``train_episode`` (the first ``episodes[0]`` in phase A), then the
    adapted head's detections and OOD scores of the last one, with every
    check of the phase. Returns (the built episodes, K1 / K3 / K4
    launches, the detections)."""
    mc = trainer.meta_cfg
    model = trainer.model
    on_card = trainer.device.type == "cuda"
    rng = np.random.default_rng(0)
    frozen = {n: t.detach().clone() for n, t in
              list(model.named_parameters()) + list(model.named_buffers())
              if not n.startswith("class_net.") or "running_" in n}
    names = [(t, n) for t, d in trainer.meta_params.items() for n in d]
    sync_if(on_card)
    reset_launches()
    batches = [builder.build(*synthetic_episode(mc, rng, gen, colors,
                                                trainer.device))
               for _ in range(sum(episodes))]
    before = _snapshot(trainer.meta_params)
    metrics, steps = [], []
    for i, batch in enumerate(batches):
        phase_a = i < episodes[0]
        m = trainer.train_episode(batch, phase_a=phase_a)
        metrics.append(m)
        if not phase_a and i % mc.meta_batch_size == mc.meta_batch_size - 2:
            lrs = [g for (t, _), g in zip(names, trainer.accum)
                   if t == "inner_lrs"]
            check(all(bool(torch.isfinite(g).all()) for g in lrs)
                  and any(bool(g.any()) for g in lrs),
                  f"episode {i}: the inner LRs' accumulated phase-B "
                  "gradients are not finite and nonzero")
        if m.get("meta_step"):
            now = _snapshot(trainer.meta_params)
            check(_moved(before, now, "class_net") and
                  _moved(before, now, "proj"),
                  f"meta step at episode {i}: the class head or the "
                  "ProjectionNet did not move")
            check(not _moved(before, now, "inner_lrs"),
                  f"meta step at episode {i}: the inner LRs moved before "
                  f"lr_stage_step {mc.lr_stage_step}")
            steps.append(i)
            before = now
    batch = batches[-1]
    dets = trainer.episode_detections(batch)
    ood_dets, det_ood, gt_ood, gt_valid = trainer.episode_ood_scores(batch)
    sync_if(on_card)
    launches = launch_counts()
    log(f"[8] meta path: {len(batches)} episodes ({episodes[0]} phase A), "
        f"meta steps after episodes {steps}, launches {launches}")
    for i, m in enumerate(metrics):
        values = {k: float(v) for k, v in m.items()}
        log(f"[8] episode {i}: " + ", ".join(f"{k} {v:.6g}"
                                             for k, v in values.items()))
        check(all(math.isfinite(v) for v in values.values()),
              f"non-finite metrics at episode {i}")
    size = mc.meta_batch_size
    check(steps == list(range(size - 1, len(batches), size)),
          f"meta steps after episodes {steps}, not every {size}th")
    now = dict(list(model.named_parameters()) + list(model.named_buffers()))
    changed = [n for n, t in frozen.items() if not torch.equal(now[n], t)]
    check(not changed, f"trunk parameters or BatchNorm statistics moved: "
          f"{changed[:5]}")
    log(f"[8] class head and ProjectionNet moved at every meta step, the "
        f"inner LRs did not (LR 0 before step {mc.lr_stage_step}); "
        f"{len(frozen)} trunk parameters and BatchNorm statistics "
        "bit-unchanged")
    q = mc.num_qry + mc.num_zero_images
    if on_card:
        check(launches["K3"] == launches["K4"] == len(batches),
              f"K3 and K4 must launch once a build: {launches}")
        check(launches["K1"] == 2,
              f"K1 must launch once a detections / OOD call: {launches}")
        check(launches["K2"] == 0, "K2 launched on f32 logits")
    check(tuple(dets.shape) == (q, mc.max_dets, 6)
          and bool(torch.isfinite(dets).all()), "detections shape / finite")
    n_det = int((dets[..., 4] > 0).sum())
    check(n_det > 0, "no detections on the meta path")
    check(torch.equal(ood_dets, dets), "the OOD path's detections differ")
    check(tuple(det_ood.shape) == (q, mc.max_dets)
          and tuple(gt_ood.shape) == tuple(gt_valid.shape)
          == tuple(batch["qry_gt_cls"].shape)
          and bool(torch.isfinite(det_ood).all())
          and bool(torch.isfinite(gt_ood).all()), "OOD shapes / finite")
    log(f"[8] detections {tuple(dets.shape)}: {n_det} kept; det_ood "
        f"{tuple(det_ood.shape)}, gt_ood {tuple(gt_ood.shape)}, "
        f"{int(gt_valid.sum())} valid ground-truth boxes")
    return batches, launches, dets


def meta_plain_compare(trainer, batch, tag="[8]"):
    """The adapted head's outputs on ``batch`` through K1 and through its
    plain version: keep indices equal, detections to 1e-4. Returns (the
    candidates, the scores' max abs error)."""
    mc, cfg = trainer.meta_cfg, trainer.model_cfg
    cls, box = mep._adapted_query_outputs(
        trainer.model, trainer.proj_net, trainer.meta_params, batch, mc)
    cand = pp.select_candidates(cls, box, trainer.qry_anchors(),
                                cfg.num_classes, cfg.max_detection_points)
    kw = dict(max_det_per_image=mc.max_dets, iou_threshold=mc.nms_thresh)
    dets_k, keep_k = pp.batch_detection(*cand[:4], kernels=True, **kw)
    dets_p, keep_p = pp.batch_detection(*cand[:4], kernels=False, **kw)
    sync()
    check(torch.equal(keep_k, keep_p), f"{tag} keep indices differ")
    check(torch.allclose(dets_k, dets_p, rtol=1e-4, atol=1e-4),
          f"{tag} kernel and plain detections differ")
    err = float((dets_k[..., 4] - dets_p[..., 4]).abs().max())
    log(f"{tag} kernel and plain detections equal on the meta path "
        f"({int((keep_k >= 0).sum())} kept), score max abs err {err:.3g}")
    return cand, err


def nms_times(cand, max_out, iou_threshold, tag, info=()):
    """K1 (hard NMS, ``max_out`` an image) at a path's candidates
    (``info``: the images' (img_scale, img_size), or none): its time by
    CUDA events beside its bound and its plain version."""
    _, scores, offset_boxes = pp.nms_inputs(*cand[:4], *info)
    kw = dict(max_out=max_out, iou_threshold=iou_threshold, soft=False)
    keep, _ = cuda_nms.batched_nms(offset_boxes, scores, **kw)
    bound, by = nms_bound_ms(keep, scores.shape[1], soft=False)
    k1 = dict(ms=cuda_ms(lambda: cuda_nms.batched_nms(offset_boxes, scores,
                                                      **kw), 50),
              plain_ms=cuda_ms(lambda: batched_nms_plain(offset_boxes, scores,
                                                         **kw), 5),
              bound_ms=bound, bound_by=by, library_ms=None)
    picks = int(torch.clamp((keep >= 0).sum(dim=1) + 1, max=max_out).max())
    dev = torch.cuda.current_device()
    log(f"{tag} [{CARD}] K1 hard [{scores.shape[0]}, {scores.shape[1]}] -> "
        f"{max_out}: {k1['ms']:.4f} ms, plain {k1['plain_ms']:.3f} ms, "
        f"bound {bound:.5f} ms ({by}); cluster "
        f"{cuda_nms.device_cluster_size(dev, *scores.shape)}, "
        f"{k1['ms'] * 1e3 / picks:.3f} us a pick over {picks} picks")
    return k1


def meta_kernel_times(trainer, batch, cand, anchor_boxes, tag="[8]"):
    """K1 at the meta path's candidates (hard NMS, 30 an image) and K3 / K4
    on an episode's query ground truth at 640 px: CUDA-event times beside
    their bounds and plain versions."""
    mc = trainer.meta_cfg
    k1 = nms_times(cand, mc.max_dets, mc.nms_thresh, tag)
    t = label_kernel_times(anchor_boxes, batch["qry_gt_bbox"],
                           batch["qry_gt_cls"], tag=f"{tag} [{CARD}]")
    return {"K1": k1, **t}


def meta_throughput(trainer, batches, window_s=WINDOW_S):
    """Episodes a second over a ``window_s`` window in each phase (each
    episode ending in a synchronise; a meta step every meta_batch_size
    episodes), the median / least / most episode time and meta-step time
    (the meta batch's episodes with the update), and the peak device
    memory."""
    size = trainer.meta_cfg.meta_batch_size
    torch.cuda.reset_peak_memory_stats()
    for phase_a, pool in ((True, batches[:META_EPISODES[0]]),
                          (False, batches[META_EPISODES[0]:])):
        name = "A" if phase_a else "B"
        times, steps, acc = [], [], 0.0
        start = time.perf_counter()
        while time.perf_counter() - start < window_s or len(times) < size:
            t0 = time.perf_counter()
            m = trainer.train_episode(pool[len(times) % len(pool)], phase_a)
            sync()
            times.append((time.perf_counter() - t0) * 1e3)
            acc += times[-1]
            if m.get("meta_step"):
                steps.append(acc)
                acc = 0.0
        ep = sorted(times)
        log(f"[8] [{CARD}] phase {name}: {len(times) * 1e3 / sum(times)} "
            "episodes/s "
            f"over {len(times)} episodes; episode ms median "
            f"{ep[len(ep) // 2]}, min {ep[0]}, max {ep[-1]}; meta step ms "
            f"(its {size} episodes and the update) median "
            f"{sorted(steps)[len(steps) // 2]}, min {min(steps)}, max "
            f"{max(steps)} over {len(steps)}")
    log(f"[8] [{CARD}] peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")


def meta_profile(trainer, batch):
    """Where a phase-B episode's time goes (profile_window): the whole
    episode's meta-gradient, its forward (the episode loss), and its
    stages apart — the supports' trunk, the inner adaptation (second
    order), the queries' trunk and box head, the query class head with
    the adapted weights and the detection loss, the projection
    regularizer; backward is episode minus forward."""
    model, proj, mc = trainer.model, trainer.proj_net, trainer.meta_cfg
    mp = trainer.meta_params
    cfg = trainer.model_cfg
    with torch.no_grad():
        supp = mep._image_features(model, batch["supp_images"], mc)
        qry = mep._image_features(model, batch["qry_images"], mc)
        box = mep._box_head(model, qry, mc)
    fast, _ = inner_adapt(model, proj, mp["class_net"], mp["proj"],
                          mp["inner_lrs"], supp, mc)

    def support_trunk():
        with torch.no_grad():
            return mep._image_features(model, batch["supp_images"], mc)

    def query_trunk_box():
        with torch.no_grad():
            return mep._box_head(model, mep._image_features(
                model, batch["qry_images"], mc), mc)

    def query_class_loss():
        return detection_loss_nhwc(
            class_head(model, qry, fast), box, batch["qry_cls"],
            batch["qry_box"], batch["qry_num_positives"], cfg.num_classes,
            cfg.alpha, cfg.gamma, cfg.delta, cfg.box_loss_weight,
            label_smoothing=cfg.label_smoothing,
            legacy_focal=cfg.legacy_focal,
            focal_modulation=cfg.focal_modulation)

    stages = {
        "episode (loss + meta-gradient)":
            lambda: trainer.episode_grads(batch, phase_a=False),
        "episode loss (forward)": lambda: mep.maml_episode_loss(
            model, proj, mp, batch, mc, cfg, trainer.proj_level_sizes),
        "support trunk": support_trunk,
        "inner adapt (second order)": lambda: inner_adapt(
            model, proj, mp["class_net"], mp["proj"], mp["inner_lrs"], supp,
            mc),
        "query trunk + box head": query_trunk_box,
        "query class head + loss": query_class_loss,
        "projection regularizer": lambda: mep.projection_phase_loss(
            model, proj, mp["class_net"], mp["proj"], batch, mc,
            trainer.proj_level_sizes),
    }
    top = collections.Counter()
    for name, fn in stages.items():
        numbers, device, _ = profile_window(fn, META_PROFILE_REPS)
        log(f"[8] [{CARD}] profile phase-B episode {name}: " + ", ".join(
            f"{k} {v}" for k, v in numbers.items()))
        if name.startswith("episode (loss"):
            for e in device:
                top[e.name[:80]] += (e.time_range.end - e.time_range.start
                                     ) / 1e3 / META_PROFILE_REPS
    for name, ms in top.most_common(12):
        log(f"[8] [{CARD}] top kernel phase-B episode: {ms:.4f} ms {name}")


def write_coco_fixture(root, n=VAL_IMAGES, seed=0):
    """A COCO-2017-layout val split under ``root``: n JPEGs at COCO's
    usual sizes in ``val2017/``, each dark noise with 1-4 flat coloured
    boxes of COCO_CATS (a colour a category), and their boxes in
    ``annotations/instances_val2017.json``."""
    from PIL import Image
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "val2017"), exist_ok=True)
    os.makedirs(os.path.join(root, "annotations"), exist_ok=True)
    colors = {cid: rng.integers(80, 256, 3) for cid, _ in COCO_CATS}
    images, anns = [], []
    for i in range(n):
        h, w = COCO_SIZES[i % len(COCO_SIZES)]
        img = rng.integers(0, 60, (h, w, 3)).astype(np.uint8)
        for _ in range(int(rng.integers(1, 5))):
            bh, bw = rng.uniform(0.1, 0.5) * h, rng.uniform(0.1, 0.5) * w
            y, x = rng.uniform(0, h - bh), rng.uniform(0, w - bw)
            cid = COCO_CATS[int(rng.integers(len(COCO_CATS)))][0]
            img[int(y):int(y + bh), int(x):int(x + bw)] = colors[cid]
            box = [round(float(v), 2) for v in (x, y, bw, bh)]
            anns.append(dict(id=len(anns) + 1, image_id=i + 1,
                             category_id=cid, bbox=box, iscrowd=0,
                             area=box[2] * box[3]))
        name = f"{i + 1:012d}.jpg"
        Image.fromarray(img).save(os.path.join(root, "val2017", name),
                                  quality=90)
        images.append(dict(id=i + 1, file_name=name, height=h, width=w))
    with open(os.path.join(root, "annotations", "instances_val2017.json"),
              "w") as f:
        json.dump(dict(images=images, annotations=anns, categories=[
            dict(id=cid, name=name) for cid, name in COCO_CATS]), f)


def reference_name(path, leaf):
    """The reference effdet torch name of a JAX-tree variable (module path,
    leaf): the inverse of checkpoint_convert._translate_name."""
    parts = []
    for p in path:
        if re.fullmatch(r"blocks_\d+_\d+", p):
            parts += ["blocks"] + p.split("_")[1:]
        elif p == "bn_stem":
            parts.append("bn1")
        elif re.fullmatch(r"(resample|cell|fnode|conv_rep)_\d+", p):
            parts += p.rsplit("_", 1)
        elif p == "after_combine_conv":
            parts += ["after_combine", "conv"]
        elif re.fullmatch(r"bn_rep_\d+_\d+", p):
            parts += ["bn_rep"] + p.split("_")[2:] + ["bn"]
        else:
            parts.append(p)
    torch_leaf = {"kernel": "weight", "scale": "weight",
                  "mean": "running_mean", "var": "running_var"}
    return ".".join(parts + [torch_leaf.get(leaf, leaf)])


def reference_state_dict(model):
    """``model``'s tensors under the reference effdet names: each tensor's
    JAX-tree path (utils.from_jax's rules) turned back into its torch
    name."""
    state = {}
    for module_name, module in model.named_modules():
        is_norm = isinstance(module, from_jax._NORMS)
        for leaf, t in (list(module.named_parameters(recurse=False))
                        + list(module.named_buffers(recurse=False))):
            target = from_jax._flax_leaf(leaf, is_norm)
            if target is not None:
                state[reference_name(from_jax._flax_module_path(module_name),
                                     target[1])] = t.detach().cpu().clone()
    return state


def write_reference_pth(path):
    """The seeded D0 (90 classes, seed 0) with three class biases raised by
    2, saved as a reference-named state_dict."""
    model = create_model("efficientdet_d0", num_classes=NUM_CLASSES, seed=0,
                         device="cpu")
    with torch.no_grad():
        model.class_net.predict_bias().view(9, NUM_CLASSES)[:, :3] += 2.0
    torch.save(reference_state_dict(model), path)


def validate_path(root, pth, device="cuda", image_size=IMG, batch=VAL_BATCH):
    """Phase 9's drive: ``validate.main`` over the COCO-layout split at
    ``root`` with the reference-named weights ``pth`` (bf16, energy OOD),
    with every check of the phase that its device allows. Returns
    (validate's metrics, the K1 / K2 launches of that run, the predict
    bench, the loader's batches, the run_validation times of a second,
    warm pass)."""
    on_card = torch.device(device).type == "cuda"
    common = ["--dataset", "coco2017", "--data", root, "--checkpoint", pth,
              "--batch-size", str(batch), "--ood-method", "energy",
              "--compute-dtype", "bfloat16", "--image-size", str(image_size)]
    if not on_card:           # the card is validate's default device
        common += ["--device", device]

    def run(extra):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):      # validate's JSON line
            metrics = validate.main(common + extra)
        sync_if(on_card)
        return metrics, out.getvalue().strip()

    n_images = len(json.load(open(os.path.join(
        root, "annotations", "instances_val2017.json")))["images"])
    n_batches = -(-n_images // batch)
    reset_launches()
    metrics, printed = run([])
    launches = {"K1": cuda_nms.batched_nms.launches,
                "K2": cuda_reduce.key_energy_reduce.launches}
    log(f"[9] [{CARD}] validate: {printed}; launches {launches}")
    check(metrics["images"] == n_images,
          f"validate evaluated {metrics['images']} of {n_images} images")
    check(all(math.isfinite(v) for v in metrics.values()),
          f"non-finite metrics {metrics}")
    check("ood_mean" in metrics, "no detections to score")
    if on_card:
        check(launches == {"K1": n_batches, "K2": n_batches},
              f"K1 and K2 must launch once a batch ({n_batches}): "
              f"{launches}")

    args = validate.build_argparser().parse_args(common)
    bench = create_model("efficientdet_d0", bench_task="predict",
                         num_classes=NUM_CLASSES, checkpoint_path=pth,
                         ood_method="energy", compute_dtype="bfloat16",
                         image_size=(image_size, image_size), device=device)
    batches = list(validate.make_val_loader(args, bench.config,
                                            torch.device(device)))
    check(len(batches) == n_batches
          and batches[-1]["image"].shape[0] == n_images - batch * (
              n_batches - 1), "the loader's batches")

    # the kernels and their plain versions on every batch
    for b in batches:
        cls, box = bench.model(b["image"])
        cand_k, cand_p = (pp.select_candidates(
            cls, box, bench.anchors, NUM_CLASSES, 5000, "energy", kernels=k)
            for k in (True, False))
        check(all(torch.equal(x, y) for x, y in zip(cand_k[:-1],
                                                    cand_p[:-1])),
              f"candidates differ between K2 and its plain version at "
              f"B={cls[0].shape[0]}")
        check(torch.allclose(cand_k.ood_all, cand_p.ood_all, rtol=1e-5,
                             atol=1e-5), "energies differ beyond rtol 1e-5")
        (dets_k, keep_k), (dets_p, keep_p) = (pp.batch_detection(
            *c[:4], kernels=k) for c, k in ((cand_k, True), (cand_p, False)))
        sync_if(on_card)
        check(torch.equal(keep_k, keep_p),
              f"K1 keep indices differ at B={cls[0].shape[0]}")
        check(torch.allclose(dets_k, dets_p, rtol=1e-6, atol=0),
              "detections differ between the kernel and plain paths")
        ood_k, ood_p = (pp._gather_survivor_scores(c.ood_all, keep,
                                                   c.indices)
                        for c, keep in ((cand_k, keep_k), (cand_p, keep_p)))
        check(torch.allclose(ood_k, ood_p, rtol=1e-5, atol=1e-5),
              "OOD scores differ beyond rtol 1e-5")
    log(f"[9] kernel and plain paths: equal candidates and keep indices on "
        f"all {n_batches} batches (the last of "
        f"{batches[-1]['image'].shape[0]}), detections to rtol 1e-6, "
        "OOD scores to rtol 1e-5")

    # the two pair selections, 2 batches each
    for method in ("exact", "approx"):
        m, _ = run(["--topk-method", method, "--max-batches", "2"])
        check(m["images"] == 2 * batch and all(
            math.isfinite(v) for v in m.values()), f"{method}: {m}")
        for b in batches[:2]:
            cls, box = bench.model(b["image"])
            cand_k, cand_p = (pp.select_candidates(
                cls, box, bench.anchors, NUM_CLASSES, 5000, "energy",
                kernels=k, topk_method=method) for k in (True, False))
            check(torch.equal(cand_k.indices, cand_p.indices)
                  and torch.equal(cand_k.classes, cand_p.classes)
                  and torch.equal(cand_k.logits, cand_p.logits),
                  f"{method}: candidate ids differ from the plain version")
        log(f"[9] --topk-method {method}: {m}; candidate ids equal to the "
            "plain version's on 2 batches")

    # the ground truth as detections scores AP 1.0
    oracle = {"coco": CocoEvaluator(NUM_CLASSES),
              "pascal": PascalEvaluator(NUM_CLASSES)}
    for b in batches:
        gt = torch.cat([b["bbox"][..., [1, 0, 3, 2]],
                        torch.ones_like(b["cls"][..., None],
                                        dtype=torch.float32),
                        b["cls"][..., None].to(torch.float32)], dim=-1)
        gt = torch.where((b["cls"] > 0)[..., None], gt, torch.zeros_like(gt))
        for ev in oracle.values():
            ev.add_predictions(gt, b)
    ap = {"coco": oracle["coco"].evaluate()["map"],
          "pascal": oracle["pascal"].evaluate()["mAP@0.5IOU"]}
    log(f"[9] ground truth as detections: {ap}; native evaluation core "
        f"loads: {native.available()}")
    check(all(abs(v - 1.0) < 1e-12 for v in ap.values()),
          f"the evaluators score the ground truth {ap}, not AP 1.0")

    # a second, warm pass through run_validation for its times
    loader = validate.make_val_loader(args, bench.config,
                                      torch.device(device))
    _, times = validate.run_validation(bench, loader, CocoEvaluator(
        NUM_CLASSES), "energy")
    check(times["batches"] == n_batches, f"run_validation: {times}")
    return metrics, launches, bench, batches, times


def validate_measures(bench, batches, metrics, times):
    """Phase 9's numbers on the card: images/s, the load / predict /
    evaluate wall time, the card's idle share over one batch's predict,
    and K1 (hard) / K2 at the full batch and at the partial last one."""
    n = sum(b["image"].shape[0] for b in batches)
    log(f"[9] [{CARD}] validate: {metrics['img_per_sec']} images/s over "
        f"{n} images (the first call, build and warm-up included); warm "
        f"run_validation {n / sum(times[k] for k in ('load_s', 'predict_s', 'evaluate_s'))}"
        f" images/s: load {times['load_s']} s, predict {times['predict_s']}"
        f" s, evaluate {times['evaluate_s']} s over {times['batches']} "
        "batches")
    image = batches[0]["image"]
    numbers, _, _ = profile_window(lambda: bench(image))
    log(f"[9] [{CARD}] profile predict B={image.shape[0]}: " + ", ".join(
        f"{k} {v}" for k, v in numbers.items()))
    out = {}
    for b in (batches[0], batches[-1]):
        cls, box = bench.model(b["image"])
        cand = pp.select_candidates(cls, box, bench.anchors, NUM_CLASSES,
                                    5000, "energy")
        out[cls[0].shape[0]] = kernel_times(cand, cls, (None, None),
                                            soft=False, tag="[9]")
    return out


def json_lines(text):
    """The JSON objects among a driver's printed lines."""
    out = []
    for line in text.splitlines():
        try:
            out.append(json.loads(line))
        except ValueError:
            continue
    return out


def run_driver(main_fn, argv, tag, **kw):
    """``main_fn(argv, **kw)`` with its printed lines captured and logged
    under ``tag`` (so that this script's stdout keeps its own JSON lines
    only). Returns (what main returned, its printed text, its JSON
    lines)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = main_fn(argv, **kw)
    text = out.getvalue()
    for line in text.strip().splitlines():
        log(f"{tag} {line}")
    return result, text, json_lines(text)


def launch_counts():
    return {"K1": cuda_nms.batched_nms.launches,
            "K2": cuda_reduce.key_energy_reduce.launches,
            "K3": cuda_labeler.batch_match.launches,
            "K4": cuda_labeler.batch_codes_targets.launches}


def states_equal(a, b):
    """Whether two TrainStates hold the same step, parameters, BatchNorm
    statistics, EMA and optimizer state, bit for bit."""
    if a.step != b.step:
        return False
    for x, y in zip(a.model.state_dict().values(),
                    b.model.state_dict().values()):
        if not torch.equal(x, y):
            return False
    if any(not torch.equal(v, b.ema_params[n])
           for n, v in a.ema_params.items()):
        return False
    for p, q in zip(a.model.parameters(), b.model.parameters()):
        sa, sb = a.optimizer.state[p], b.optimizer.state[q]
        if sa.keys() != sb.keys() or any(not torch.equal(sa[k], sb[k])
                                         for k in sa):
            return False
    return True


@contextlib.contextmanager
def timed_train_steps(device):
    """A StepTimer around every step function that
    ``train_state.make_train_step`` returns inside the block (the pretrain
    CLI builds its step through it): CUDA events on the card, each step
    waited for. Yields the timer."""
    timer = StepTimer(window=10 ** 6, device=device)
    make = train_state_mod.make_train_step

    def timed_make(*args, **kwargs):
        step_fn = make(*args, **kwargs)

        def timed(state, batch):
            timer.tic()
            out = step_fn(state, batch)
            timer.toc()
            return out
        return timed

    train_state_mod.make_train_step = timed_make
    try:
        yield timer
    finally:
        train_state_mod.make_train_step = make


def trace_idle(path, span="train_step"):
    """From a Chrome trace of torch.profiler: (wall ms from the first
    ``span`` annotation's start to the last one's end, the card's busy ms
    in it: the union of its kernel, copy and set intervals, the card's
    idle share, the ms inside the ``span`` annotations)."""
    events = json.load(open(path))["traceEvents"]
    marks = [e for e in events if e.get("name") == span
             and e.get("cat") == "user_annotation"]
    check(marks, f"no {span} annotation in {path}")
    t0 = min(e["ts"] for e in marks)
    t1 = max(e["ts"] + e["dur"] for e in marks)
    device = [SimpleNamespace(time_range=SimpleNamespace(
        start=max(e["ts"], t0), end=min(e["ts"] + e["dur"], t1)))
        for e in events if e.get("cat") in ("kernel", "gpu_memcpy",
                                             "gpu_memset")
        and e["ts"] < t1 and e["ts"] + e.get("dur", 0) > t0]
    check(device, f"the trace {path} holds no device activity")
    wall = (t1 - t0) / 1e3
    busy = busy_ms(device)
    return wall, busy, 1.0 - busy / wall, sum(e["dur"] for e in marks) / 1e3


PRETRAIN_ARGS = ("--num-classes", str(NUM_CLASSES), "--batch-size",
                 str(TRAIN_BATCH), "--val-steps", "2", "--log-freq", "5",
                 "--eval-map", "--workers", "4", "--mesh", "1")


def pretrain_path(tmp, device="cuda", steps=20, val_freq=10, extra=()):
    """Phase 10's drive: ``train.pretrain.main`` at D0@512, 90 classes,
    batch 32 on synthetic data (``extra`` overrides flags), ``steps``
    steps with validation and --eval-map every ``val_freq`` (a
    torch.profiler trace of steps 10-15 when there are that many), then
    --resume for 4 more steps, then a 6-step --stream run; with every
    check of the phase that its device allows. Returns (the first run's
    final state, its logs, the StepTimer of its train steps
    (timed_train_steps), the launches of each run, the trace's path or
    None)."""
    on_card = torch.device(device).type == "cuda"
    base = list(PRETRAIN_ARGS) + ["--device", device,
                                  "--checkpoint-dir", f"{tmp}/ck",
                                  "--per-cat-dir", f"{tmp}/pc"] + list(extra)
    trace_dir = f"{tmp}/trace" if steps >= 15 else ""
    argv = base + ["--steps", str(steps), "--val-freq", str(val_freq),
                   "--profile-dir", trace_dir]
    args = pretrain.build_argparser().parse_args(argv)
    val_steps = args.val_steps
    launches = {}

    sync_if(on_card)
    reset_launches()
    with timed_train_steps(device) as timer:
        state, _, logs = run_driver(pretrain.main, argv, "[10] pretrain:")
    sync_if(on_card)
    launches["run"] = launch_counts()
    losses = [e for e in logs if "loss" in e]
    check(len(losses) == steps // args.log_freq and all(
        e[k] is not None and math.isfinite(e[k]) for e in losses
        for k in ("loss", "class_loss", "box_loss")),
        "pretrain: a logged loss is missing or not finite")
    rounds = steps // val_freq
    check([e["step"] for e in logs if "val_mAP" in e]
          == [val_freq * (i + 1) for i in range(rounds)],
          "pretrain: val_mAP not logged at each validation")
    for i in range(rounds):
        for kind in ("ap", "corloc"):
            check(os.path.exists(f"{tmp}/pc/test_{kind}_{val_freq * (i + 1)}"
                                 ".npy"), f"pretrain: no {kind} dump")
    fresh_model = create_model_from_config(state.model.config, seed=7,
                                           device=device)
    fresh, _ = create_train_state(fresh_model,
                                  default_detection_train_config())
    ckpt = CheckpointManager(f"{tmp}/ck")
    check(ckpt.latest_step() == steps and states_equal(
        state, ckpt.restore(fresh)),
        "pretrain: the checkpoint does not restore the final state")
    val_batches = rounds * val_steps
    if on_card:
        want = {"K1": val_batches, "K2": 0, "K3": steps + val_batches,
                "K4": steps + val_batches}
        check(launches["run"] == want,
              f"pretrain: launches {launches['run']}, not {want}")
    log(f"[10] pretrain: {steps} steps, {rounds} validations of "
        f"{val_steps} batches, launches {launches['run']}; the checkpoint "
        "at the last step restores the final state bit for bit")

    reset_launches()
    state2, text, logs2 = run_driver(
        pretrain.main, base + ["--steps", str(steps + 4), "--val-freq",
                               str(val_freq), "--resume"], "[10] resume:")
    sync_if(on_card)
    launches["resume"] = launch_counts()
    check(f"resumed from step {steps}" in text and state2.step == steps + 4
          and logs2[-1]["final_step"] == steps + 4,
          "pretrain --resume did not continue from the saved step")
    rounds2 = (steps + 4) // val_freq - rounds
    if on_card:
        n = 4 + rounds2 * val_steps
        check(launches["resume"]["K3"] == launches["resume"]["K4"] == n,
              f"pretrain --resume: launches {launches['resume']}")

    reset_launches()
    state3, _, logs3 = run_driver(
        pretrain.main, base + ["--stream", "--steps", "6", "--val-freq", "3",
                               "--checkpoint-dir", f"{tmp}/ck_stream"],
        "[10] stream:")
    sync_if(on_card)
    launches["stream"] = launch_counts()
    # each val block is summarised when the next train batch arrives
    check(state3.step == 6 and [e["step"] for e in logs3 if "val_loss" in e]
          == [2, 5] and all(math.isfinite(e["val_loss"])
                            for e in logs3 if "val_loss" in e),
          "pretrain --stream: steps or val blocks")
    if on_card:
        want = {"K1": 4, "K2": 0, "K3": 10, "K4": 10}
        check(launches["stream"] == want,
              f"pretrain --stream: launches {launches['stream']}, not {want}")
    log(f"[10] resume: {launches['resume']}; stream: 6 steps, 2 val blocks, "
        f"launches {launches['stream']}")
    trace = f"{trace_dir}/trace.json" if trace_dir else None
    return state, logs, timer, launches, trace


def pretrain_kernels(state, device="cuda", extra=()):
    """K1 / K3 / K4 at the pretrain path's call sites, on its first val
    batch: the labels kernel vs plain (label_compare) and their times;
    the EMA model's candidates (three class biases raised by 2, so that
    the NMS has work) through K1 and its plain version, and K1's time."""
    args = pretrain.build_argparser().parse_args(
        list(PRETRAIN_ARGS) + ["--device", device] + list(extra))
    model = state.model
    cfg = model.config
    _, val_loader = pretrain.make_loaders(args, cfg, torch.device(device))
    batch = next(iter(val_loader))
    anchors = Anchors.from_config(cfg)
    anchor_boxes = torch.from_numpy(anchors.boxes).to(device)
    _, err_box, codes, _ = label_compare(anchor_boxes, batch["bbox"],
                                         batch["cls"], unmatched=0.5)
    variables = dict(state.variables(use_ema=True))
    bias = next(n for n, p in model.named_parameters()
                if p is model.class_net.predict_bias())
    raised = variables[bias].detach().clone().view(9, cfg.num_classes)
    raised[:, :3] += 2.0
    variables[bias] = raised.view(-1)
    model.eval()
    cls, box = torch.func.functional_call(model, variables,
                                          (batch["image"],))
    cand = pp.select_candidates(cls, box, anchors, cfg.num_classes,
                                cfg.max_detection_points)
    dets_k, keep_k = pp.batch_detection(*cand[:4], kernels=True)
    dets_p, keep_p = pp.batch_detection(*cand[:4], kernels=False)
    sync()
    check(torch.equal(keep_k, keep_p), "[10] K1 keep indices differ")
    check(torch.allclose(dets_k, dets_p, rtol=1e-4, atol=1e-4),
          "[10] K1 and plain detections differ")
    err = float((dets_k[..., 4] - dets_p[..., 4]).abs().max())
    log(f"[10] pretrain val batch {tuple(batch['image'].shape)}: K3 / K4 "
        f"equal to plain ({int((codes >= 0).sum())} positives), K1 keep "
        f"equal ({int((keep_k >= 0).sum())} kept), score max abs err "
        f"{err:.3g}")
    t = label_kernel_times(anchor_boxes, batch["bbox"], batch["cls"],
                           tag=f"[10] [{CARD}]")
    t["K1"] = nms_times(cand, cfg.max_det_per_image, 0.3, "[10]")
    return t


def pretrain_measures(logs, timer, trace):
    """Phase 10's numbers: the logger's images/s at each log step, the
    median train step by CUDA events, the card's idle share over the
    traced steps 10-15, the peak device memory."""
    rates = [e["img_per_sec"] for e in logs if "img_per_sec" in e]
    median = timer.median * 1e3
    log(f"[10] [{CARD}] pretrain D0@512 B={TRAIN_BATCH}: img_per_sec by "
        f"log step {rates}; median train step {median:.3f} ms (CUDA "
        f"events, {TRAIN_BATCH * 1e3 / median:.2f} images/s), min "
        f"{min(timer.times) * 1e3:.3f}, max {max(timer.times) * 1e3:.3f}")
    wall, busy, idle, in_steps = trace_idle(trace)
    log(f"[10] [{CARD}] traced steps 10-15 (profiler on): wall {wall:.3f} "
        f"ms, {in_steps:.3f} ms of it inside the train steps, card busy "
        f"{busy:.3f} ms, idle {100 * idle:.1f} %")
    log(f"[10] [{CARD}] peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")


def loader_rate(cfg, batches=6):
    """The pretrain path's train loader alone (phase 10's flags: 4
    threads, pinned copy, normalised on the card): images/s over
    ``batches`` batches after its first. Also ``--re-prob 1``: the same
    first batch with a rectangle erased on the card in every image."""
    args = pretrain.build_argparser().parse_args(list(PRETRAIN_ARGS))
    train, _ = pretrain.make_loaders(args, cfg, torch.device("cuda"))
    it = iter(train)
    first = next(it)
    args.re_prob = 1.0
    erasing, _ = pretrain.make_loaders(args, cfg, torch.device("cuda"))
    erased = next(iter(erasing))
    changed = (erased["image"] != first["image"]).any(-1).flatten(1).any(1)
    check(bool(changed.all()) and bool(torch.isfinite(erased["image"]).all())
          and torch.equal(erased["bbox"], first["bbox"]),
          "--re-prob 1: RandomErasing on the card")
    sync()
    t0 = time.perf_counter()
    for _ in range(batches):
        next(it)
    sync()
    rate = batches * TRAIN_BATCH / (time.perf_counter() - t0)
    it.close()
    log(f"[10] [{CARD}] the train loader alone: {rate:.2f} images/s over "
        f"{batches} batches of {TRAIN_BATCH}")


META_DRIVER_ARGS = ("--proj-iters", "4", "--total-iters", "12",
                    "--val-freq", "6", "--log-freq", "4", "--eval-map",
                    "--eval-ood")


@contextlib.contextmanager
def counted(cls, name, record):
    """Count the calls of method ``name`` of ``cls`` in ``record[name]``
    (and keep its last result in ``record['last ' + name]``) while the
    block runs."""
    original = getattr(cls, name)
    record[name] = 0
    lock = threading.Lock()       # episodes are built on two threads

    def wrapper(self, *args, **kwargs):
        result = original(self, *args, **kwargs)
        with lock:
            record[name] += 1
            record["last " + name] = result
        return result
    setattr(cls, name, wrapper)
    try:
        yield record
    finally:
        setattr(cls, name, original)


def meta_driver_path(tmp, device="cuda", extra=()):
    """Phase 11's drive: ``meta.train_driver.main`` at its defaults (640 px
    queries, 256 px supports, 1-way, 25 supports, 25 + 6 queries, meta
    batch 4) on synthetic categories, 4 phase-A then phase-B iterations
    to 12, validation from iteration 6 with --eval-map and --eval-ood
    (``extra`` overrides flags); with every check of the phase that its
    device allows. Returns (the trainer, the logs, the launches, the
    last episode built)."""
    on_card = torch.device(device).type == "cuda"
    base = list(META_DRIVER_ARGS) + ["--device", device, "--per-cat-dir",
                                     f"{tmp}/pc"] + list(extra)
    calls = {}
    sync_if(on_card)
    reset_launches()
    with counted(EpisodeBuilder, "build", calls), \
            counted(MetaTrainer, "episode_detections", calls), \
            counted(MetaTrainer, "episode_ood_scores", calls):
        trainer, _, logs = run_driver(
            train_driver.main, base + ["--checkpoint-dir", f"{tmp}/ck"],
            "[11] meta driver:")
    sync_if(on_card)
    launches = launch_counts()
    phases = {e.get("phase") for e in logs if "phase" in e}
    check(phases == {"proj", "maml"}, f"meta driver: phases {phases}")
    check(logs[-1].get("final_iter") == 12, "meta driver: final_iter")
    ood = [e["ood_auroc_gt"] for e in logs if "ood_auroc_gt" in e]
    check(ood and all(isinstance(v, float) and 0.0 <= v <= 1.0
                      for v in ood), f"meta driver: ood_auroc_gt {ood}")
    for e in logs:
        for k, v in e.items():
            check(not isinstance(v, float) or math.isfinite(v),
                  f"meta driver: {k} {v}")
    fresh, _, _ = run_driver(
        train_driver.main, base + ["--total-iters", "0", "--checkpoint-dir",
                                   f"{tmp}/ck_fresh"], "[11] fresh:")
    CheckpointManager(f"{tmp}/ck").restore(fresh.meta_params)
    check(all(torch.equal(fresh.meta_params[t][n], v)
              for t, d in trainer.meta_params.items() for n, v in d.items()),
          "meta driver: the saved meta_params do not load back bit-equal")
    detections = calls["episode_detections"] + calls["episode_ood_scores"]
    if on_card:
        check(launches["K3"] == launches["K4"] == calls["build"] > 0,
              f"meta driver: K3 / K4 must launch once a build "
              f"({calls['build']}): {launches}")
        check(launches["K1"] == detections > 0 and launches["K2"] == 0,
              f"meta driver: K1 must launch once a detections / OOD call "
              f"({detections}): {launches}")
    log(f"[11] meta driver: {calls['build']} episodes built, {detections} "
        f"detections / OOD calls, launches {launches}; the saved meta_params "
        "load into a fresh trainer bit for bit")
    return trainer, logs, launches, calls["last build"]


META_RATE_ARGS = ("--proj-iters", "4", "--total-iters", "12",
                  "--val-freq", "100", "--log-freq", "4")


def meta_driver_rate(tmp, device="cuda", extra=()):
    """Phase 11's training rate: ``meta.train_driver.main`` at its defaults
    for 4 phase-A then 8 phase-B iterations, its first validation block
    due at draw 100, so that every iteration is a training episode (in
    meta_driver_path's drive, validation from draw 6, iterations 6-12 are
    validation episodes). Returns its logs."""
    _, _, logs = run_driver(
        train_driver.main, list(META_RATE_ARGS) + [
            "--device", device, "--checkpoint-dir", f"{tmp}/ck_rate",
            "--per-cat-dir", f"{tmp}/pc_rate"] + list(extra),
        "[11] training rate:")
    blocks = [(e["iter"], e["phase"]) for e in logs if "phase" in e]
    check(blocks == [(4, "proj"), (8, "maml"), (12, "maml")]
          and not any("val_loss" in e for e in logs),
          f"meta driver training rate: blocks {blocks}")
    return logs


def episode_build_rate(trainer, episodes=3):
    """The meta driver's episode source alone (its synthetic categories,
    the trainer's configs): ms a train episode built on this thread, PIL
    to labels on the card, after a first one."""
    mc = trainer.meta_cfg
    src = SyntheticEpisodeSource(num_cats=6, img_hw=(mc.img_size,) * 2)
    cats = list(range(1, 7))
    dataset = EpisodicDataset(src.support_source(cats), src,
                              trainer.model_cfg, mc, train_cats=cats[:4],
                              val_cats=cats[4:], device=trainer.device)
    dataset._episode(val_iter=False)
    sync()
    t0 = time.perf_counter()
    for _ in range(episodes):
        dataset._episode(val_iter=False)
    sync()
    ms = (time.perf_counter() - t0) * 1e3 / episodes
    log(f"[11] [{CARD}] the episode source alone: {ms:.1f} ms an episode "
        f"({1e3 / ms:.3f} episodes/s) over {episodes}")


def meta_driver_measures(logs, rate_logs):
    """Phase 11's numbers: episodes/s of each logged block by phase, of
    the training-only run (meta_driver_rate) and of the checked drive,
    whose phase-B blocks are validation episodes from iteration 6; the
    peak device memory."""
    for name, entries in (("training episodes only", rate_logs),
                          ("checked drive, validation from iteration 6",
                           logs)):
        for phase in ("proj", "maml"):
            rates = [(e["iter"], e["eps_per_sec"]) for e in entries
                     if e.get("phase") == phase]
            log(f"[11] [{CARD}] meta driver phase {phase} ({name}): "
                f"eps_per_sec by (iteration, rate) {rates}")
    log(f"[11] [{CARD}] peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")


def sync_if(on_card):
    if on_card:
        sync()


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    # f32 convolutions would run TF32 by default; nothing here compares
    # f32 model outputs, but keep every f32 op at full precision
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    global CARD
    CARD = smi
    log(f"[1] card: {smi}; torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")
    pil, jpeg, gxx = host_facts()
    log(f"[1] host: PIL {pil or 'does not import'}; libjpeg "
        f"{jpeg or 'not found'} (ctypes.util.find_library); g++ "
        f"{gxx or 'not on PATH'}")

    # 2. build
    t0 = time.time()
    build_logs = cuda_build.build_all()
    for source, out in build_logs.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"    {source}: {line.strip()}")
    log(f"[2] built {sorted(cuda_build.SOURCES)} in {time.time() - t0:.1f} s")

    # 3. kernels vs plain versions on the card
    gen = torch.Generator(device="cuda").manual_seed(0)
    for batch in (BATCH, 128):
        for name, make in (("tied", tied_logits), ("random", random_logits)):
            err = k2_compare(make(batch, gen))
            log(f"[3] K2 {name} B={batch}: key bit-exact, energy max abs err "
                f"{err:.3g}")
    levels = tied_logits(3, gen, img=128)
    plan = cuda_reduce.tile_plan([lvl.shape for lvl in levels], NUM_CLASSES)
    check(plan.rows[-1] == 27 and not list(cuda_reduce.plan_tiles(plan))[-1][4],
          "D0@128 at batch 3 must end on a ragged tile")
    err = k2_compare(levels)
    k2_compare(levels, energy=False)
    k2_compare(tied_logits(BATCH, gen), energy=False)
    log(f"[3] K2 D0@128 B=3 (ragged last tile, P7 27 rows): key bit-exact, "
        f"energy max abs err {err:.3g}; energy=False at B=3 and {BATCH}: "
        "key bit-exact")
    for c in (20, 21):   # the kernel's 32-bit (even C) and 16-bit (odd) reads
        err = k2_compare([
            (torch.randn((2, 16 >> lvl, 16 >> lvl, 9 * c), generator=gen,
                         device="cuda") * 2.0 - 3.0).to(torch.bfloat16)
            for lvl in range(3)], num_classes=c)
        log(f"[3] K2 C={c}: key bit-exact, energy max abs err {err:.3g}")
    for batch, n in ((BATCH, 5000), (128, 5000), (2, 1001),
                     (VAL_BATCH, 5000), (VAL_IMAGES % VAL_BATCH, 5000)):
        boxes, scores = random_nms_inputs(batch, n, gen)
        chosen = cuda_nms.device_cluster_size(torch.cuda.current_device(),
                                              batch, n)
        for soft in (False, True):
            errs = [k1_compare(boxes, scores, soft, cluster=c)
                    for c in (None,) + cuda_nms.CLUSTER_SIZES]
            log(f"[3] K1 [{batch}, {n}] soft={soft}: keep equal at the "
                f"wrapper's cluster ({chosen}) and at clusters "
                f"{cuda_nms.CLUSTER_SIZES}, score max abs err "
                f"{max(errs):.3g}")
    anchor_boxes = torch.from_numpy(Anchors.from_config(
        get_efficientdet_config("efficientdet_d0")).boxes).cuda()
    label_inputs = {}
    for batch in (TRAIN_BATCH, 128):
        boxes, cls = ground_truth(batch, gen, cases=True)
        label_inputs[batch] = (boxes, cls)
        for unmatched in (0.5, 0.3):
            err_k3, err, codes, (_, _, best) = label_compare(
                anchor_boxes, boxes, cls, unmatched)
            check(bool((codes[1] == -1).all()), "all-padding image matched")
            check(int(best[0, 0]) == int(best[0, 1])
                  and int(codes[0, best[0, 0]]) == 0,
                  "identical rows: the lower row must take the anchor")
            check(int(best[0, 2]) == 0 and int(codes[0, 0]) == 2,
                  "a row overlapping nothing must claim anchor 0")
            check(bool((codes == -2).any()) == (unmatched < 0.5),
                  "ignore band")
            log(f"[3] K3 / K4 [{batch}, {MAX_ROWS}] x {anchor_boxes.shape[0]}"
                f" anchors, unmatched {unmatched}: match and codes "
                f"bit-exact, class targets equal, box max abs err {err:.3g}"
                f", {int((codes == -2).sum())} ignored")
            if batch == TRAIN_BATCH:
                err_match = err_k3
    label_hazards(anchor_boxes, gen)
    meta_kernel_cases(gen)
    sync()

    # 4. main path: 3 requests of 16 canvases
    bench = create_model("efficientdet_d0", bench_task="predict",
                         num_classes=NUM_CLASSES, soft_nms=True,
                         ood_method="energy", compute_dtype="bfloat16",
                         seed=0, device="cuda")
    # a few classes above the 0.01 score floor
    bench.model.class_net.predict_bias().view(9, NUM_CLASSES)[:, :3] += 2.0
    requests = [canvases(BATCH, gen) for _ in range(3)]
    sync()
    reset_launches()
    for imgs, hw in requests:
        pre = batched_letterbox_normalize(imgs, hw, target_hw=(IMG, IMG),
                                          out_dtype="bfloat16")
        dets, ood = bench(pre["image"], pre)
    sync()
    launches = {"K1": cuda_nms.batched_nms.launches,
                "K2": cuda_reduce.key_energy_reduce.launches}
    log(f"[4] main path: 3 requests x {BATCH} images, launches {launches}")
    check(launches["K1"] > 0 and launches["K2"] > 0,
          f"a kernel of the main path never launched: {launches}")
    check(launches["K2"] == len(requests),
          f"K2 must launch once a request: {launches['K2']} launches for "
          f"{len(requests)} requests")
    check(tuple(dets.shape) == (BATCH, 100, 6)
          and tuple(ood.shape) == (BATCH, 100), "output shapes")
    check(bool(torch.isfinite(dets).all()) and bool(torch.isfinite(ood).all()),
          "non-finite outputs")
    n_det = int((dets[..., 4] > 0).sum())
    check(n_det > 0, "no detections")
    log(f"[4] {n_det} detections in the last request; first: "
        f"{[round(v, 3) for v in dets[0, 0].tolist()]}, "
        f"energy {float(ood[0, 0]):.4f}")

    # the same batch through the plain path on the card
    cls, box = bench.model(pre["image"])
    err_k2 = k2_compare(cls)
    cand_k, cand_p = (pp.select_candidates(
        cls, box, bench.anchors, NUM_CLASSES, 5000, "energy", kernels=k)
        for k in (True, False))
    # the selection is bit-exact; the energies agree to f32 summation order
    check(all(torch.equal(a, b) for a, b in zip(cand_k[:-1], cand_p[:-1])),
          "candidates differ between K2 and its plain version")
    check(torch.allclose(cand_k.ood_all, cand_p.ood_all, rtol=1e-5,
                         atol=1e-5), "energies differ beyond rtol 1e-5")
    info = (pre["img_scale"], pre["img_size"])
    dets_k, keep_k = pp.batch_detection(*cand_k[:4], *info, soft_nms=True,
                                        kernels=True)
    dets_p, keep_p = pp.batch_detection(*cand_p[:4], *info, soft_nms=True,
                                        kernels=False)
    sync()
    check(torch.equal(keep_k, keep_p), "keep indices differ on the main path")
    err_k1 = float((dets_k[..., 4] - dets_p[..., 4]).abs().max())
    check(torch.allclose(dets_k, dets_p, rtol=1e-4, atol=1e-4),
          "detections differ between the kernel and plain paths")
    log(f"[4] plain path on the same batch: equal keep indices "
        f"({int((keep_k >= 0).sum())} kept), score max abs err {err_k1:.3g}")

    # 5. times: the kernels at the main path's shapes (batch 16) and at
    #    batch 128, end to end at both; card as printed above
    t = kernel_times(cand_k, cls, info)
    for batch in (BATCH, 128):
        throughput(bench, batch, gen)
    sync()
    del bench, cls, box, requests, cand_k, cand_p
    torch.cuda.empty_cache()

    # 6. the train path, 3 steps at batch 32; 7. its times
    with torch.enable_grad():
        train = train_path(gen)
        err_label = train[-1]
        launches.update(train[-2])
        for batch in (TRAIN_BATCH, 128):
            t_label = label_kernel_times(anchor_boxes, *label_inputs[batch])
            if batch == TRAIN_BATCH:
                t.update(t_label)
        for batch in (TRAIN_BATCH, 128):
            train_throughput(*train[:5], batch, gen)
    sync()
    del train
    torch.cuda.empty_cache()

    # 8. the meta path: 1 phase-A and 2 phase-B meta steps, the adapted
    #    head's detections and OOD scores; then its times
    with torch.enable_grad():
        trainer, builder, colors = meta_setup(gen)
        batches, _, _ = meta_path(trainer, builder, colors, gen)
        cand, _ = meta_plain_compare(trainer, batches[-1])
        meta_kernel_times(trainer, batches[-1], cand, torch.from_numpy(
            builder.qry_anchors.boxes).cuda())
        meta_throughput(trainer, batches)
        meta_profile(trainer, batches[-1])
    sync()
    del trainer, batches
    torch.cuda.empty_cache()

    # 9. the offline evaluation entry point on a COCO-layout split
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        root, pth = os.path.join(tmp, "coco"), os.path.join(tmp, "d0.pth")
        write_coco_fixture(root)
        write_reference_pth(pth)
        metrics, _, bench, batches, times = validate_path(root, pth)
        validate_measures(bench, batches, metrics, times)
    sync()
    log(f"[9] phase 9 took {time.time() - t0:.1f} s")
    del bench, batches
    torch.cuda.empty_cache()

    # 10. the pretrain CLI (D0@512, 90 classes, batch 32: 20 steps with
    #     validation and --eval-map, then --resume, then --stream) and
    # 11. the meta training CLI at its defaults. Both run f32 models, with
    #     PyTorch's default TF32 setting for cuDNN convolutions, as a user
    #     runs them; nothing here compares their f32 outputs across
    #     frameworks.
    torch.backends.cudnn.allow_tf32 = True
    t0 = time.time()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp, torch.enable_grad():
        state, logs, timer, _, trace = pretrain_path(tmp)
        pretrain_measures(logs, timer, trace)
        loader_rate(state.model.config)
        pretrain_kernels(state)
    sync()
    log(f"[10] phase 10 took {time.time() - t0:.1f} s")
    del state
    torch.cuda.empty_cache()
    t0 = time.time()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp, torch.enable_grad():
        trainer, logs, _, episode = meta_driver_path(tmp)
        meta_driver_measures(logs, meta_driver_rate(tmp))
        episode_build_rate(trainer)
        # the class bias raised by 2 (as in phase 8) so that K1 has work
        with torch.no_grad():
            trainer.model.class_net.predict_bias().add_(2.0)
        cand, _ = meta_plain_compare(trainer, episode, tag="[11]")
        meta_kernel_times(trainer, episode, cand, torch.from_numpy(
            trainer.qry_anchors().boxes).cuda(), tag="[11]")
    sync()
    log(f"[11] phase 11 took {time.time() - t0:.1f} s")
    del trainer, episode

    kernels = [
        dict(name="K1 batched soft/hard NMS", route="cuda",
             source=REPO_KERNELS["K1"][0], replaces=REPO_KERNELS["K1"][1],
             launches=launches["K1"], max_abs_err=err_k1, **t["K1"]),
        dict(name="K2 packed key + energy reduce", route="cuda",
             source=REPO_KERNELS["K2"][0], replaces=REPO_KERNELS["K2"][1],
             launches=launches["K2"], max_abs_err=err_k2, **t["K2"]),
        dict(name="K3 anchor match (IoU, per-anchor and per-row argmax)",
             route="cuda", source=REPO_KERNELS["K3"][0],
             replaces=REPO_KERNELS["K3"][1], launches=launches["K3"],
             max_abs_err=err_match, **t["K3"]),
        dict(name="K4 match codes + targets (thresholds, force-match, "
             "class and box targets)", route="cuda",
             source=REPO_KERNELS["K4"][0], replaces=REPO_KERNELS["K4"][1],
             launches=launches["K4"], max_abs_err=err_label, **t["K4"]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def reset_launches():
    """Every kernel's launch count to 0 (before a path is driven)."""
    for fn in (cuda_nms.batched_nms, cuda_reduce.key_energy_reduce,
               cuda_labeler.batch_match, cuda_labeler.batch_codes_targets):
        fn.launches = 0


def kernel_times(cand, cls, info, soft=True, tag="[5]"):
    """Each kernel's time (CUDA events, after warm-up) beside its bound, its
    plain version and a library call, on the inputs a path gives it: the
    candidates ``cand`` of the post-process with the images' (img_scale,
    img_size) ``info``, and the bf16 class outputs ``cls``; K1 soft or
    hard. Logs them under ``tag`` and returns the JSON fields."""
    batch = cls[0].shape[0]
    _, scores, offset_boxes = pp.nms_inputs(*cand[:4], *info)
    nms_kw = dict(max_out=100, iou_threshold=0.3, soft=soft)
    keep, _ = cuda_nms.batched_nms(offset_boxes, scores, **nms_kw)
    k1_bound, k1_by = nms_bound_ms(keep, scores.shape[1], soft=soft)
    k1 = dict(
        ms=cuda_ms(lambda: cuda_nms.batched_nms(offset_boxes, scores,
                                                **nms_kw), 50),
        plain_ms=cuda_ms(lambda: batched_nms_plain(offset_boxes, scores,
                                                   **nms_kw), 5),
        bound_ms=k1_bound, bound_by=k1_by, library_ms=None)
    k2_bound, k2_by = reduce_bound_ms(cls)
    k2 = dict(
        ms=cuda_ms(lambda: cuda_reduce.key_energy_reduce(
            cls, NUM_CLASSES, True), 50),
        plain_ms=cuda_ms(lambda: cuda_reduce.key_energy_reduce_plain(
            cls, NUM_CLASSES, True), 5),
        bound_ms=k2_bound, bound_by=k2_by,
        library_ms=cuda_ms(lambda: [torch.logsumexp(
            lvl.reshape(batch, -1, NUM_CLASSES), dim=-1) for lvl in cls], 20))
    # the images run side by side: the one with the most picks sets the time
    picks = int(torch.clamp((keep >= 0).sum(dim=1) + 1, max=100).max())
    dev = torch.cuda.current_device()
    kind = "soft" if soft else "hard"
    log(f"{tag} [{CARD}] K1 {kind} [{batch}, {scores.shape[1]}]: "
        f"{k1['ms']:.4f} ms, plain "
        f"{k1['plain_ms']:.3f} ms, bound {k1_bound:.5f} ms ({k1_by}); "
        f"cluster {cuda_nms.device_cluster_size(dev, *scores.shape)}, "
        f"{k1['ms'] * 1e3 / picks:.3f} us a pick over {picks} picks")
    nms_cluster_times(offset_boxes, scores, picks, nms_kw, tag)
    if batch == BATCH and tag == "[5]":
        # an intermediate batch: the same candidates twice over
        nms_cluster_times(torch.cat([offset_boxes] * 2),
                          torch.cat([scores] * 2), picks, nms_kw, tag)
    log(f"{tag} [{CARD}] K2 B={batch}: {k2['ms']:.4f} ms, plain "
        f"{k2['plain_ms']:.3f} "
        f"ms, logsumexp {k2['library_ms']:.4f} ms, bound {k2_bound:.4f} ms "
        f"({k2_by}), {100 * k2_bound / k2['ms']:.1f} % of it reached")
    return {"K1": k1, "K2": k2}


def nms_cluster_times(boxes, scores, picks, nms_kw, tag="[5]"):
    """K1's time (CUDA events) at the wrapper's cluster size and at each
    forced one, and how many images of these candidates the card holds at
    once at each, over ``picks`` picks."""
    dev = torch.cuda.current_device()
    batch, n = scores.shape
    chosen = cuda_nms.device_cluster_size(dev, batch, n)
    for c in cuda_nms.CLUSTER_SIZES:
        ms = cuda_ms(lambda: cuda_nms.batched_nms(
            boxes, scores, cluster=c, **nms_kw), 50)
        mark = " (the wrapper's choice)" if c == chosen else ""
        kind = "soft" if nms_kw["soft"] else "hard"
        log(f"{tag} [{CARD}] K1 {kind} [{batch}, {n}] at cluster {c}{mark}: "
            f"{ms:.4f} ms, "
            f"{ms * 1e3 / picks:.3f} us a pick; the card holds "
            f"{cuda_nms.resident_images(dev, n, c)} images at once")


def busy_ms(events):
    """Length of the union of the device events' intervals, in ms."""
    total, end = 0.0, float("-inf")
    for start, stop in sorted((e.time_range.start, e.time_range.end)
                              for e in events):
        if stop > end:
            total += stop - max(start, end)
            end = stop
    return total / 1e3


def profile_window(fn, reps=PROFILE_REPS):
    """Where one call of fn spends its time: the host clock over ``reps``
    calls with the profiler off (wall), then the union of the card's
    kernel, copy and set intervals over ``reps`` calls in a torch.profiler
    window (busy), the card's idle share of the wall time, the device
    operations of a call that the profiler kept (ops) and those the host
    issued (issued: its CUDA runtime calls that put one on the card).
    Returns (those numbers, the device events, a count of the runtime calls
    by name)."""
    fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync()
    wall = (time.perf_counter() - t0) * 1e3 / reps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        sync()
    events = prof.events()
    device = [e for e in events if e.device_type == DeviceType.CUDA]
    check(len(device) > 0, "the profiler recorded no device activity")
    issued = collections.Counter(
        e.name for e in events
        if e.device_type == DeviceType.CPU and e.name.startswith(RUNTIME_OPS))
    busy = busy_ms(device) / reps
    return dict(wall_ms=wall, busy_ms=busy, idle=1.0 - busy / wall,
                ops=len(device) / reps,
                issued=sum(issued.values()) / reps), device, issued


def throughput(bench, batch, gen):
    """End to end at ``batch`` over uint8 canvases already on the card.
    Requests (preproc -> forward -> post-process, each ending in a
    synchronise) run until WINDOW_S seconds have passed: images/s over the
    window, and the median, least and most request time. Then a profiler
    window of the whole request and of each stage alone (profile_window),
    and the kernels with the most device time in a request. At batches
    other than the main path's, also the kernels' times on this batch."""
    imgs, hw = canvases(batch, gen)

    def preproc():
        return batched_letterbox_normalize(imgs, hw, target_hw=(IMG, IMG),
                                           out_dtype="bfloat16")

    def request():
        pre = preproc()
        return bench(pre["image"], pre)

    request()
    sync()
    times = []
    start = time.perf_counter()
    while time.perf_counter() - start < WINDOW_S:
        t0 = time.perf_counter()
        request()
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    times.sort()
    log(f"[5] end to end B={batch}: {batch * len(times) * 1e3 / sum(times)}"
        f" images/s over {len(times)} requests; request ms median "
        f"{times[len(times) // 2]}, min {times[0]}, max {times[-1]}")

    pre = preproc()
    cls, box = bench.model(pre["image"])
    stages = {
        "request": request,
        "preproc": preproc,
        "forward": lambda: bench.model(pre["image"]),
        "post": lambda: pp.generate_detections(
            cls, box, bench.anchors, NUM_CLASSES, img_scale=pre["img_scale"],
            img_size=pre["img_size"], soft_nms=True, ood_method="energy"),
    }
    top = collections.Counter()
    for name, fn in stages.items():
        numbers, device, _ = profile_window(fn)
        log(f"[5] profile B={batch} {name}: " + ", ".join(
            f"{k} {v}" for k, v in numbers.items()))
        if name == "request":
            for e in device:
                top[e.name[:80]] += (e.time_range.end - e.time_range.start
                                     ) / 1e3 / PROFILE_REPS
    for name, ms in top.most_common(10):
        log(f"[5] top kernel B={batch}: {ms:.4f} ms {name}")
    if batch != BATCH:
        kernel_times(pp.select_candidates(cls, box, bench.anchors,
                                          NUM_CLASSES, 5000, "energy"), cls,
                     (pre["img_scale"], pre["img_size"]))


if __name__ == "__main__":
    with torch.no_grad():
        sys.exit(main())
