#!/usr/bin/env python3
"""Drive the PyTorch port's paths on one CUDA card and hold its
hand-written kernels against their plain PyTorch versions.

Predict, train and validate run EfficientDet-D0 at its full width (512 x
512 input, 90 classes, bf16 compute), random weights from a seed (the
meta path, phase 8, its meta model; phase 13 the other families of the
zoo):
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
  - serving (phase 12): the same predict path as one torch.export artifact
    with the weights and the letterbox inside, K2 and K1 as custom
    operators; the deploy CLI: JPEGs -> PIL or native decode + letterbox
    -> pinned copy to the card -> normalise -> forward -> K2 -> K1 ->
    boxes in the original image;
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
 12. the serving path (serving_path): D0@512, 90 classes, bf16, soft-NMS,
     energy OOD exported once by ``export.export_predict`` with the uint8
     letterbox inside and a symbolic batch, saved, loaded
     (``export.load_artifact``) and served at 1, 8 and 16 canvases: the
     detections and OOD scores torch.equal to the live path's (letterbox,
     then forward_with_ood), each artifact call launching K2 once and K1
     once; the export / save / load seconds and the artifact's MB;
     images/s of the artifact and the live path at batch 16 and 128, a
     window each, and a profiler window of each; the artifact loaded onto
     the CPU; then ``examples.deploy_infer`` on the five deploy-fixture
     JPEGs with the golden fixture's recipe of weights, on the card and
     with --device cpu: counts, top scores and OOD scores held to each
     other to tests/test_deploy_golden.py's tolerances, and the model's
     head outputs on the card to the CPU's within 1.25 times the CPU's
     own f64-vs-f32 conv-sum difference; and its images/s over 320
     JPEGs.
 13. model breadth: (a) CSPResDet-50 (CSPResNet-50, leaky-ReLU, SiLU
     plain-conv heads, bilinear upsampling, 76,725 anchors) at 640 px,
     90 classes, bf16, soft-NMS, energy, three class biases raised,
     through create_model(..., bench_task="predict"): 3 requests of 16
     canvases, K2 and K1 once a request, finite outputs with detections,
     the plain path equal on the last batch; K1 / K2 timed beside their
     bounds, end to end at batch 16 and 64 with profiler windows (as
     phase 5); (b) ``train.pretrain.main --model cspresdet50`` (f32,
     batch 16, synthetic data, 8 steps, --eval-map every 4): finite
     losses and val_mAP, K3 / K4 once a train step and a val batch, K1
     once a val batch; img_per_sec, the median step, the peak memory;
     (c) ``train.pretrain.main --model efficientdet_d4 --dropout 0.2``
     (1024 px, 196,416 anchors, f32, batch 4, 3 steps) plain and with
     --remat 3 --remat-fpn-heads from the same seed: step 1's loss and
     grad_norm within 1e-5 relative, the BatchNorm statistics after step
     1 within 1e-6, the rematted run's peak memory lower; K3 / K4 at
     196,416 anchors against their plain versions and timed; (d) each of
     the 19 zoo entries of ZOO_SWEEP at full width and its published
     size, 90 classes, bf16, batch 2: one request through K2 -> K1 (once
     each), finite outputs of their shapes; build s, request ms and peak
     memory, a line an entry.
 14. data parallelism (data_parallel): each drive is a ``python -m
     torch.distributed.run`` launch of this script's ``--rank`` mode
     (rank_main), whose ranks print into ``<out>/rank<r>.log``: (a) two
     ranks on cuda:0 over gloo (DP_BATCH images each): step 1 of
     ``make_train_step(mesh=...)`` at D0@512, 90 classes, f32 with TF32
     off, against one process on the global batch (losses and grad_norm
     to rtol 2e-4, num_positives exactly, the update within 3 times the
     relative L2 spread of one process on the batch reversed), a timed
     window and a profiler window of its collectives (TF32 on), then the
     pretrain CLI with ``--mesh 2`` (DP_STEPS steps, --eval-map every
     DP_VAL_FREQ): the merged val loss and saved_best equal on both
     ranks, the checkpoint written by rank 0 alone, K3 / K4 once a step
     and a val batch and K1 once a val batch on each rank; (b) one rank
     over NCCL: (a)'s step timed with its collective window, then the CLI
     as that rank (``--mesh 1``), 3 steps; (c) ``validate --mesh 2``
     over phase 9's fixture at 8 a rank against phase 9's metrics, the
     ground truth at AP 1.0 through the merged evaluators, K2 and K1 once
     a non-empty batch on each rank; (d) the meta driver with
     ``--episode-mesh 2`` at its defaults for 2 phase-B updates, logs and
     meta parameters equal on both ranks, K3 / K4 once a build, and one
     update of ``make_sharded_meta_step`` on 4 phase-8 episodes (two a
     rank) against ``train_episode``'s sequential accumulation to rtol
     1e-5; (a)-(d) run beside phase 15's two example processes, so their
     timed windows share the host and the card with them. (e) only where
     the machine has two cards or more: (a) with
     phase 3's kernel cases on every rank's own card, (c) and (d) over
     NCCL with one rank a card, and the train step's images/s at
     DP_RATE_BATCH a card with 1, 2 and all cards; with one card it
     logs that and goes on.
 15. the examples (examples_path): ``examples.open_set_demo.main`` and
     ``examples.selection_quality.main --out <file>`` at their defaults
     (D0 at full width, 256 px, batch 16, 500 steps, f32), the two at
     once, each in a process of its own (``chip_smoke.py --example
     <json>``, example_main) with torch's deterministic algorithms, so
     that a run trains the same weights every time; the processes start
     before phase 14 and run beside its torchrun ranks: each JSON line
     printed with its time, the
     wall seconds of each stage and the kernels' launches; K3 / K4 once a
     train step and K1 once a predict call (once a method and val batch
     in selection_quality), K2 logged (f32 takes no packed route); finite
     AUROC / FPR95 and mAPs, ``approx``'s overlap with ``exact`` at least
     EXAMPLE_MIN_OVERLAP and ``exact``'s PASCAL mAP@0.5 at least
     EXAMPLE_MIN_PASCAL; then at the examples' shapes (example_kernels)
     K3 -> K4 and K1 against their plain versions and timed.
 16. the spatial leg (spatial_path): a torchrun launch of this script's
     ``--rank`` mode (rank_spatial), two ranks on cuda:0 over gloo as a
     (1, 2) (data, spatial) mesh, each holding half of every image's
     rows: step 1 of ``make_train_step(..., spatial_axis="spatial")`` at
     D0@512, 90 classes, f32 with TF32 off, ``freeze_bn="none"``, 8
     images, against one process on the same images to phase 14 (a)'s
     bars (hold_step1); then SPATIAL_STEPS steps timed with K3 / K4 once
     a step on each rank, the spatial group's exchanges (halos, gathers,
     squeeze-excite sums) a step, a profiler window of one step's
     collectives and exchanges with their host ms (the ``odt.spatial.*``
     spans), and each rank's step peak memory, which must
     be below one process's on the 8 images. With four cards
     (``--cards``, spatial_cards): the same at (2, 2) over NCCL, one rank
     a card, then one step of tf_efficientdet_d7x at 1536 px, f32, one
     image, on (1, 4) (spatial_d7x: finite losses, K3 / K4 once, each
     card's peak memory); with fewer cards it logs that and goes on.
 17. the benchmark entry point (bench_path): (a) ``run_bench.main()`` at
     its defaults (D0@512, 90 classes, bf16, batch 128) with BENCH_ITERS
     timed calls a row: the train row, the exact top-k row and the
     north-star row last, in the JAX bench's names, each finite and
     positive; K3 / K4 once a timed train step, K2 and K1 once a call of
     the exact row and of the north-star row; (b)
     ``BENCH_MODE=meta`` at its defaults (bf16, 640 / 256 px;
     BENCH_META_ITERS timed calls a run: K3 / K4 once, at the episode's
     build) and ``BENCH_MODE=loader`` at batch 128
     (PIL where the native core does not load); (c) ``python -m
     ood_object_detection_tpu_torch.run_bench`` as a subprocess with
     BENCH_CLI_ENV; (d) the north-star and train rows no faster than
     BENCH_ROW_MARGIN x 128 images over phase 5's / phase 7's B = 128
     busy seconds (a faster row timed the enqueue); (e)
     ``examples.train_roofline`` (D0@512, batch 64, nothing frozen) with
     a profiler trace, ``examples.profile_kernel_stats`` over the trace
     and ``examples.run_roofline_sweep --only predict`` (D4@1024, batch
     16, a subprocess), every roofline share in (0, 1]. Each row is logged
     with the card's name and power limit, never as a bare JSON line.
 18. published weights and timm checkpoints (pretrained_path), through
     ``import ood_object_detection_tpu_torch as odt``: (a) phase 9's
     reference-named D0 under efficientdet_d0's published file name in a
     cache directory, ``OOD_TPU_CHECKPOINT_CACHE`` set to it and
     ``urllib.request.urlretrieve`` raising; ``odt.create_model(...,
     pretrained=True)`` with no device (D0@512, 90 classes, bf16,
     soft-NMS, energy) answers 3 requests of 16 canvases: no fetch, the
     load report with nothing missing or unexpected, K2 once a request
     and K1, finite outputs with detections, every request's detections
     and OOD scores torch.equal to ``checkpoint_path=`` on the file, the
     plain path equal on the last batch; (b) timm's training checkpoint
     of the same weights (``args`` an ``argparse.Namespace``, ``metric`` a
     float) with an EMA copy raising three other classes:
     ``checkpoint_ema=True`` loads the EMA class bias and answers a
     request as a bare file of the EMA state_dict does, and the deploy
     CLI's ``load_checkpoint`` reads the file as "reference". The phase's
     wall seconds and a B = 16 request's ms (CUDA events, median of 3)
     are logged with the card's name and power limit. Its K1 / K2
     launches count in the kernels line with phase 4's and the rest.
Phases 10, 11, 13, 14, 15 and 17 run with PyTorch's default cuDNN TF32
(the earlier phases turn it off), as a user runs the CLIs; phase 14
turns it off for its equality step, phase 16 for all of it.
Phase 3 also holds K1 at the meta path's [31, 5000] -> 30 (hard, 0.3),
K3 -> K4 at 31 images x 76,725 anchors (6 images all padding) and an
episode's query labels through the kernels against the plain ones, K1
at the validate path's [8, 5000] and [5, 5000], and at phase 13's shapes
K2 on 640 px levels (batch 16, 64) and 1024 px levels (batch 2, 4) and
K3 -> K4 at 196,416 anchors (batch 4, 16) with the hazard rows.

Phase 1 also logs whether PIL imports, whether libjpeg and g++ are found.
Prints a JSON line of per-kernel numbers, the nvidia-smi line, and last
{"ok": true, "device": {...}}. Any failure exits non-zero with no result.

Usage: python3 chip_smoke.py        (one CUDA card; nvcc on PATH or in
                                     $CUDA_HOME/bin, default /usr/local/cuda)
       python3 chip_smoke.py --cards  (phases 1, 2, 14 (e) and phase 16's
                                     four-card part alone, on two cards
                                     or more)
       (``python3 chip_smoke.py --rank <json>`` is one rank of phase 14
       or 16,
       started by its torchrun launches; ``--example <json>`` one example
       of phase 15.)
"""
import argparse
import collections
import contextlib
import ctypes.util
import importlib
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
import traceback
import urllib.request
from types import SimpleNamespace
from unittest import mock

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import ood_object_detection_tpu_torch as odt
from ood_object_detection_tpu_torch.data.device_preproc import (
    batched_letterbox_normalize)
from ood_object_detection_tpu_torch import export, run_bench, validate
from ood_object_detection_tpu_torch.data import (NativeEvalLoader,
                                                 PilEvalLoader,
                                                 SyntheticDetectionDataset,
                                                 collate_batch,
                                                 native_decode_available,
                                                 normalize_uint8)
from ood_object_detection_tpu_torch.data.episodic import (
    EpisodeBuilder, EpisodicDataset, SyntheticEpisodeSource)
from ood_object_detection_tpu_torch.examples import (deploy_infer,
                                                     open_set_demo,
                                                     profile_kernel_stats,
                                                     run_roofline_sweep,
                                                     selection_quality,
                                                     train_roofline)
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
                                                cuda_nms, cuda_reduce,
                                                cuda_update)
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
from ood_object_detection_tpu_torch.train.checkpoint import save_variables
from ood_object_detection_tpu_torch.train.train_state import (
    apply_gradients, detection_loss)
from ood_object_detection_tpu_torch.utils import (StepTimer, device_time,
                                                  from_jax, load_pretrained)
from ood_object_detection_tpu_torch.utils.pretrained import PRETRAINED_URLS

# the module (the package's ``post_process`` is the function)
pp = importlib.import_module(
    "ood_object_detection_tpu_torch.ops.post_process")

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
WINDOW_S = 1.5       # end-to-end timing window at each batch
PROFILE_REPS = 4     # calls in each profiler window
TRAIN_PROFILE_REPS = 2
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
META_PROFILE_REPS = 2
# the validate path: images of the COCO-layout split (a partial last batch
# of 5 at batch 8), COCO's usual image sizes (h, w), its categories
VAL_IMAGES = 61
VAL_BATCH = 8
COCO_SIZES = ((480, 640), (640, 480), (427, 640), (375, 500), (612, 612))
COCO_CATS = ((1, "person"), (3, "car"), (18, "dog"))
# the serving path (phase 12): the batches the artifact serves and is held
# at, the batches of its images/s windows; the deploy CLI's fixture JPEGs,
# the copies of them in its images/s run, the golden fixture's class-bias
# boost (tests/deploy_fixture.py) and the rows of an image it pins
SERVE_BATCHES = (1, 8, 16)
SERVE_RATE_BATCHES = (BATCH, 128)
DEPLOY_FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "tests", "data", "deploy_fixture")
DEPLOY_COPIES = 64
DEPLOY_BOOST = ((3, 17, 42), 2.6)
DEPLOY_TOP_ROWS = 10
# model breadth (phase 13): the predict / pretrain model at full width and
# its image size, the batches of its images/s windows and its pretrain
# batch; the remat pair's model (196,416 anchors at 1024 px) and batch; the
# zoo entries that the sweep answers one request each with
BREADTH_MODEL = "cspresdet50"
BREADTH_IMG = 640
BREADTH_RATE_BATCHES = (BATCH, 64)
BREADTH_TRAIN_BATCH = 16
REMAT_MODEL = "efficientdet_d4"
REMAT_IMG = 1024
REMAT_BATCH = 4
REMAT_ANCHORS = 196416
ZOO_SWEEP = (
    "resdet50", "cspresdet50", "cspresdext50", "cspresdext50pan",
    "cspdarkdet53", "mixdet_m", "mixdet_l", "mobiledetv2_110d",
    "mobiledetv2_120d", "mobiledetv3_large", "efficientdet_w0",
    "efficientdet_es", "efficientdet_em", "efficientdet_lite0",
    "tf_efficientdet_lite0", "tf_efficientdet_lite1",
    "tf_efficientdet_lite2", "tf_efficientdet_lite3",
    "tf_efficientdet_lite4")
# the card as nvidia-smi names it (name, power limit), set by main(); the
# meta path's measurements print it on their lines
# data parallelism (phase 14): images a rank when two ranks share the card
# (the pretrain CLI's run: DP_STEPS steps, validation of DP_VAL_STEPS
# batches' images every DP_VAL_FREQ), images a card in the rate windows,
# steps a window
DP_BATCH = 16
DP_STEPS = 4
DP_VAL_FREQ = 2
DP_VAL_STEPS = 4
DP_RATE_BATCH = 32
DP_RATE_STEPS = 6
DP_PROFILE_STEPS = 2
# the examples (phase 15): the bars of the card run, approx's overlap with
# exact (the JAX run recorded an identical detection set) and exact's
# PASCAL mAP@0.5 (the card-trained detector learns; the example processes
# run deterministic algorithms: with cuDNN's and the atomic scatters'
# free summation order, 500 steps of the same seed ended anywhere from
# 0.42 to 0.88 between runs)
EXAMPLE_MIN_OVERLAP = 0.99
EXAMPLE_MIN_PASCAL = 0.6
# seconds the two example processes may take together (each took 117-121
# s alone on an H100)
EXAMPLE_TIMEOUT = 600
# the spatial leg (phase 16): the global batch, the timed steps after step
# 1, the image size of the D7x step (its published size)
SPATIAL_BATCH = 8
SPATIAL_STEPS = 3
D7X_IMG = 1536
# phase 17: the bench's timed calls a row (20, its default; 5 for the
# meta row), the loader's batches, the CLI's environment, the roofline
# rows' flags and calls
BENCH_ITERS = 20
BENCH_META_ITERS = 5
BENCH_LOADER_ITERS = 2
BENCH_CLI_ENV = {"EXTRA": "0", "BATCH": "16", "ITERS": "5"}
BENCH_ROW_MARGIN = 1.05
ROOFLINE_ITERS = 5
ROOFLINE_ARGS = ("--batch", "64", "--freeze-bn", "none", "--iters",
                 str(ROOFLINE_ITERS))
# phase 18: the published-weights path (requests of BATCH canvases) and
# the EMA copy's raised classes in a timm training checkpoint
PRETRAINED_REQUESTS = 3
EMA_CLASSES = slice(3, 6)
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
    sync_if(levels[0].is_cuda)
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


def canvases(batch, gen, img=IMG, device="cuda"):
    """uint8 canvases of img x img (512), each image's valid (h, w) in
    [img / 2, img) (the JAX package's predict_bench inputs,
    bench.py:100-104); the canvases on ``device``, (h, w) on the host."""
    imgs = torch.randint(0, 256, (batch, img, img, 3), generator=gen,
                         device=device, dtype=torch.uint8)
    hw = torch.randint(img // 2, img, (batch, 2), generator=gen,
                       device=device).cpu()
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


def update_kernel_times(model, ema, tag="[7]"):
    """The update's multi-tensor kernels at the model's parameters: each
    held against its plain version (the clip given the kernel's norm, bit
    for bit; the norm within 1e-6 relative), then timed (CUDA events over
    50 calls) beside its bytes bound and the plain loops, with the 50 MB
    L2 warm (back to back) and cold (a 128 MB memset before each call,
    whose own time is taken off). A limit of -1 keeps the clip engaged on
    every call (it flips the signs), so each call does the most work."""
    params = [p.detach() for p in model.parameters()]
    grads = [torch.empty_like(p).normal_() for p in params]
    n = sum(p.numel() for p in params)
    norm = float(cuda_update.global_norm_plain(grads))
    got, want = ([g.clone() for g in grads] for _ in range(2))
    k_norm = cuda_update.global_norm_clip_(got, 0.5 * norm)
    cuda_update.clip_scale_plain_(want, k_norm, 0.5 * norm)
    d = np.float32(0.9998)
    e_got, e_want = ([ema[k].clone() for k, _ in model.named_parameters()]
                     for _ in range(2))
    cuda_update.ema_update_(e_got, params, d)
    cuda_update.ema_update_plain_(e_want, params, d)
    sync()
    check(abs(float(k_norm) - norm) <= 1e-6 * norm
          and all(map(torch.equal, got, want))
          and all(map(torch.equal, e_got, e_want)),
          "the update kernels differ from their plain versions")
    flush = torch.empty((32 * 2 ** 20,), device="cuda")
    flush_ms = cuda_ms(flush.zero_, 50)
    cases = {
        "norm": (lambda: cuda_update.global_norm_clip_(got, 0.0),
                 lambda: cuda_update.global_norm_clip_plain_(want, 0.0), 4),
        "clip": (lambda: cuda_update.global_norm_clip_(got, -1.0),
                 lambda: cuda_update.global_norm_clip_plain_(want, -1.0),
                 12),
        "EMA": (lambda: cuda_update.ema_update_(e_got, params, d),
                lambda: cuda_update.ema_update_plain_(e_want, params, d),
                12)}
    for name, (kernel, plain, bytes_per_value) in cases.items():
        t = dict(ms=cuda_ms(kernel, 50),
                 cold_ms=cuda_ms(lambda: (flush.zero_(), kernel()), 50)
                 - flush_ms,
                 plain_ms=cuda_ms(plain, 5),
                 bound_ms=bytes_per_value * n / HBM_BYTES_PER_S * 1e3)
        log(f"{tag} update {name}, {len(params)} tensors, {n} values: "
            f"{t['ms']:.4f} ms L2-warm, {t['cold_ms']:.4f} ms cold, plain "
            f"{t['plain_ms']:.3f} ms, bound {t['bound_ms']:.5f} ms (bytes, "
            f"{bytes_per_value} a value), {100 * t['bound_ms'] / t['cold_ms']:.1f}"
            " % of it reached cold")


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
    update = {fn.__name__: fn.launches for fn in (
        cuda_update.global_norm_clip_, cuda_update.ema_update_)}
    log(f"[6] update kernels: {update}")
    check(list(update.values()) == [len(batches)] * 2,
          f"the clip and the EMA kernels must run once a step: {update} "
          f"for {len(batches)} steps")
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
    the whole step and of its stages) and its top device kernels.
    Returns the step's profile_window numbers."""
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
            step_numbers = numbers
            for e in device:
                top[e.name[:80]] += (e.time_range.end - e.time_range.start
                                     ) / 1e3 / TRAIN_PROFILE_REPS
    for name, ms in top.most_common(12):
        log(f"[7] top kernel train B={batch_size}: {ms:.4f} ms {name}")
    return step_numbers


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
    wall, busy, idle, in_steps = trace_idle(trace, span="odt.step")
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


def serving_bench(device="cuda", img=IMG):
    """Phase 12's model: D0 at img px (512), 90 classes, bf16, soft-NMS,
    energy OOD, seed 0, three class biases raised by 2 (as in phase 4) so
    that K1 has work."""
    bench = create_model("efficientdet_d0", bench_task="predict",
                         num_classes=NUM_CLASSES, soft_nms=True,
                         ood_method="energy", compute_dtype="bfloat16",
                         seed=0, device=device, image_size=(img, img))
    with torch.no_grad():
        bench.model.class_net.predict_bias().view(9, NUM_CLASSES)[:, :3] += 2.0
    return bench


def serving_inputs(batch, gen, img=IMG, device="cuda"):
    """``canvases`` with the true (h, w) as int32, the artifact's input
    signature."""
    imgs, hw = canvases(batch, gen, img=img, device=device)
    return imgs, hw.to(torch.int32)


def live_serving(bench, imgs, hw):
    """The artifact's function on the live bench: letterbox + normalise,
    then forward_with_ood (no img_info: boxes in the letterboxed frame)."""
    img = bench.config.image_size[0]
    pre = batched_letterbox_normalize(imgs, hw, target_hw=(img, img),
                                      out_dtype="bfloat16")
    return bench.forward_with_ood(pre["image"])


def serving_path(tmp, gen, device="cuda", img=IMG, batches=SERVE_BATCHES):
    """Phase 12's drive: ``serving_bench`` exported once with the uint8
    letterbox inside and a symbolic batch (``export.export_predict``),
    saved to ``tmp`` and loaded onto ``device``; at each batch of canvases
    the artifact's detections and OOD scores equal the live path's
    (torch.equal), finite, with detections, and on the card each artifact
    call launches K2 once and K1 once (no other kernel). Returns (the
    bench, the loaded artifact, the artifact's directory, the export /
    save / load seconds and its MB, the launches of each call)."""
    on_card = torch.device(device).type == "cuda"
    bench = serving_bench(device, img)
    t0 = time.perf_counter()
    ep = export.export_predict(bench, with_preproc=True)
    seconds = {"export": time.perf_counter() - t0}
    path = os.path.join(tmp, "serving")
    t0 = time.perf_counter()
    export.save_artifact(path, ep, bench)
    seconds["save"] = time.perf_counter() - t0
    seconds["MB"] = os.path.getsize(
        os.path.join(path, export.ARTIFACT_FILE)) / 2 ** 20
    with open(os.path.join(path, export.MANIFEST_FILE)) as f:
        manifest = json.load(f)
    check(manifest["with_preproc"] is True
          and not manifest["input_signature"][0]["shape"][0].isdigit(),
          f"the manifest: {manifest}")
    del ep
    t0 = time.perf_counter()
    module = export.load_artifact(path, device=device)
    sync_if(on_card)
    seconds["load"] = time.perf_counter() - t0
    log(f"[12] [{CARD}] export {seconds['export']:.1f} s, save "
        f"{seconds['save']:.1f} s, load {seconds['load']:.1f} s; artifact "
        f"{seconds['MB']:.1f} MB; manifest device {manifest['device']}, "
        f"input {manifest['input_signature']}")
    want = {"K1": int(on_card), "K2": int(on_card), "K3": 0, "K4": 0}
    launches = {}
    for batch in batches:
        imgs, hw = serving_inputs(batch, gen, img, device)
        sync_if(on_card)
        reset_launches()
        dets, ood = module(imgs, hw)
        sync_if(on_card)
        launches[batch] = launch_counts()
        check(launches[batch] == want,
              f"an artifact call at batch {batch} launched "
              f"{launches[batch]}, not {want}")
        ref_dets, ref_ood = live_serving(bench, imgs, hw)
        sync_if(on_card)
        check(tuple(dets.shape) == (batch, 100, 6)
              and tuple(ood.shape) == (batch, 100), "artifact output shapes")
        check(bool(torch.isfinite(dets).all())
              and bool(torch.isfinite(ood).all()), "non-finite outputs")
        check(torch.equal(dets, ref_dets) and torch.equal(ood, ref_ood),
              f"the artifact differs from the live path at batch {batch}")
        check(int((dets[..., 4] > 0).sum()) > 0, "no detections")
    log(f"[12] served B={list(batches)}: detections and OOD scores equal to "
        f"the live path; launches a call {launches}")
    return bench, module, path, seconds, launches


def artifact_on_cpu(path, gen, img=IMG):
    """The card-exported artifact loaded onto the CPU: one image through
    the kernels' plain versions, finite, of the right shapes, no launch."""
    t0 = time.perf_counter()
    module = export.load_artifact(path, device="cpu")
    load_s = time.perf_counter() - t0
    imgs, hw = serving_inputs(1, gen, img, gen.device)
    reset_launches()
    dets, ood = module(imgs.cpu(), hw)
    check(set(launch_counts().values()) == {0},
          "the artifact on the CPU launched a kernel")
    check(tuple(dets.shape) == (1, 100, 6) and dets.device.type == "cpu"
          and bool(torch.isfinite(dets).all())
          and bool(torch.isfinite(ood).all()), "the CPU artifact's outputs")
    log(f"[12] [{CARD}] the card-exported artifact on the CPU: loaded in "
        f"{load_s:.1f} s, {int((dets[..., 4] > 0).sum())} detections")


def window_rate(fn, batch):
    """Images/s of ``fn`` (one call = ``batch`` images, each ending in a
    synchronise) over WINDOW_S seconds after one warm-up call, and the
    median call ms."""
    fn()
    sync()
    times = []
    start = time.perf_counter()
    while time.perf_counter() - start < WINDOW_S:
        t0 = time.perf_counter()
        fn()
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    times.sort()
    return batch * len(times) * 1e3 / sum(times), times[len(times) // 2]


def serving_rate(bench, module, gen):
    """Images/s of the artifact and of the live path on the same canvases,
    a WINDOW_S window each, at each of SERVE_RATE_BATCHES; then a profiler
    window of each (profile_window: wall, device busy, idle share, device
    operations kept and issued a call)."""
    for batch in SERVE_RATE_BATCHES:
        imgs, hw = serving_inputs(batch, gen)
        paths = (("artifact", lambda: module(imgs, hw)),
                 ("live", lambda: live_serving(bench, imgs, hw)))
        for name, fn in paths:
            rate, median = window_rate(fn, batch)
            log(f"[12] [{CARD}] serving B={batch} {name}: {rate} images/s, "
                f"median call {median} ms")
        for name, fn in paths:
            numbers, _, _ = profile_window(fn)
            log(f"[12] [{CARD}] profile serving B={batch} {name}: " +
                ", ".join(f"{k} {v}" for k, v in numbers.items()))


def deploy_weights(path, device="cuda"):
    """Weights for the deploy CLI, saved to ``path`` (train.checkpoint
    .save_variables): the golden fixture's recipe
    (tests/deploy_fixture.build_checkpoint) rebuilt in the port from the
    seeded D0 at 512 px, 90 classes: every BatchNorm's running statistics
    set to its batch statistics over 4 random images (one train-mode pass
    at momentum 1), the class predict kernel x 0.01, the box predict
    kernel x 0.05 and DEPLOY_BOOST's three class biases raised, so that
    the detections depend on the image."""
    model = create_model("efficientdet_d0", num_classes=NUM_CLASSES, seed=0,
                         device=device)
    with torch.no_grad():
        norms = [m for m in model.modules() if hasattr(m, "write_stats")]
        momenta = [m.momentum for m in norms]
        for m in norms:
            m.momentum = 1.0
        calib = torch.from_numpy(np.random.default_rng(7).uniform(
            -2, 2, (4, IMG, IMG, 3)).astype(np.float32)).to(device)
        model.train()(calib)
        model.eval()
        for m, momentum in zip(norms, momenta):
            m.momentum = momentum
        model.class_net.predict.conv_pw.weight.mul_(0.01)
        model.box_net.predict.conv_pw.weight.mul_(0.05)
        classes, boost = DEPLOY_BOOST
        model.class_net.predict_bias().view(9, NUM_CLASSES)[
            :, list(classes)] += boost
    save_variables(path, model.state_dict())


@contextlib.contextmanager
def conv_sums_in_f64():
    """Within the block every ``F.conv2d`` takes its sum in f64 and rounds
    it once to its input's dtype."""
    conv2d = torch.nn.functional.conv2d

    def f64(x, weight, bias=None, *args):
        return conv2d(x.double(), weight.double(),
                      None if bias is None else bias.double(),
                      *args).to(x.dtype)

    torch.nn.functional.conv2d = f64
    try:
        yield
    finally:
        torch.nn.functional.conv2d = conv2d


def deploy_heads(ckpt, device, f64_sums=False):
    """The deploy CLI's model (bf16, the weights ``ckpt``) on ``device``
    over the five fixture JPEGs as its loader letterboxes them: every
    class and box head output, as f32 numpy arrays. With ``f64_sums`` the
    convolutions sum in f64 (conv_sums_in_f64)."""
    bench = create_model("efficientdet_d0", bench_task="predict",
                         num_classes=NUM_CLASSES, compute_dtype="bfloat16",
                         device=device)
    deploy_infer.load_checkpoint(bench.model, ckpt)
    paths = sorted(os.path.join(DEPLOY_FIXTURE, f)
                   for f in os.listdir(DEPLOY_FIXTURE) if f.endswith(".jpg"))
    loader = (NativeEvalLoader if native_decode_available()
              else PilEvalLoader)(paths, target_hw=(IMG, IMG),
                                  batch_size=len(paths))
    x = normalize_uint8(torch.from_numpy(next(iter(loader))["image"])
                        .to(device))
    with torch.no_grad(), (conv_sums_in_f64() if f64_sums
                           else contextlib.nullcontext()):
        cls, box = bench.model(x)
    return [t.float().cpu().numpy() for t in cls + box]


def head_gap(a, b):
    """(mean |a - b|, the share of outputs that differ) over every head
    output."""
    diff = np.concatenate([np.abs(x - y).ravel() for x, y in zip(a, b)])
    return float(diff.mean()), float(np.mean(diff > 0))


def deploy_run(ckpt, device, tmp, image_dir=DEPLOY_FIXTURE, batch=5):
    """``deploy_infer.main`` over ``image_dir`` with the weights ``ckpt``
    on ``device``. Returns (its results, its summary line)."""
    argv = ["--image-dir", image_dir, "--checkpoint", ckpt, "--batch-size",
            str(batch), "--device", device, "--out",
            os.path.join(tmp, f"dets_{device}.json")]
    results, _, lines = run_driver(deploy_infer.main, argv,
                                   f"[12] deploy {device}:")
    sync_if(torch.device(device).type == "cuda")
    return results, lines[0]


def deploy_rows_match(ref, got):
    """tests/test_deploy_golden.py's check of ``got`` (the deploy CLI's
    results) against ``ref``: per image the counts within 12, and each of
    ``ref``'s first DEPLOY_TOP_ROWS rows matched by a row of ``got`` of
    the same class, the box within 3 px, the score within 0.02 and the OOD
    score within 0.2. Returns the rows that fail."""
    got = {os.path.basename(r["path"]): r["detections"] for r in got}
    failed = []
    for r in ref:
        name, rows = os.path.basename(r["path"]), r["detections"]
        if abs(len(got[name]) - len(rows)) > 12:
            failed.append((name, "count", len(rows), len(got[name])))
        for row in rows[:DEPLOY_TOP_ROWS]:
            if not any(
                    g["class"] == row["class"]
                    and np.allclose(g["box_xyxy"], row["box_xyxy"], atol=3.0)
                    and abs(g["score"] - row["score"]) <= 0.02
                    and abs(g["ood_score"] - row["ood_score"]) <= 0.2
                    for g in got[name]):
                failed.append((name, row))
    return failed


def deploy_scores_match(ref, got):
    """The golden's tolerances on what the deploy fixture's weights
    determine: per image the counts within 12, and the first
    DEPLOY_TOP_ROWS scores of ``got`` (the deploy CLI's results) against
    ``ref``'s, each sorted, within 0.02, and those rows' OOD scores, each
    sorted, within 0.2. Which anchor wins among rows whose scores tie to a
    bf16 step, and so the box and class of a row, follows the f32
    rounding of the conv sums and is not held (ROADMAP fault F3). Returns
    the images that fail."""
    got = {os.path.basename(r["path"]): r["detections"] for r in got}
    failed = []
    for r in ref:
        name, rows = os.path.basename(r["path"]), r["detections"]
        top = [sorted(d, key=lambda row: -row["score"])[:DEPLOY_TOP_ROWS]
               for d in (rows, got[name])]
        scores = [sorted(row["score"] for row in t) for t in top]
        ood = [sorted(row["ood_score"] for row in t) for t in top]
        if (abs(len(got[name]) - len(rows)) > 12
                or len(scores[0]) != len(scores[1])
                or not np.allclose(scores[0], scores[1], rtol=0, atol=0.02)
                or not np.allclose(ood[0], ood[1], rtol=0, atol=0.2)):
            failed.append((name, len(rows), len(got[name]), scores, ood))
    return failed


def deploy_path(tmp, device="cuda", copies=DEPLOY_COPIES):
    """Phase 12's deploy drive with the weights of ``deploy_weights``:
    ``deploy_infer.main`` over the five fixture JPEGs on ``device`` and
    with ``--device cpu``, held to each other by ``deploy_scores_match``;
    the rows of the CPU run that no row of the device run matches to
    tests/test_deploy_golden.py's tolerances (``deploy_rows_match``) are
    counted (F3). The model's head outputs on the same canvases on
    ``device`` against the CPU's: the mean |difference| and the share
    that differ each at most 1.25 times what taking the CPU's conv sums in
    f64 instead of f32 moves them (``deploy_heads``). Then the CLI's
    images/s on ``device`` over ``copies`` links to each JPEG at its
    default batch of 8 (model build, decode, letterbox and the copy to the
    card included). Returns (the device run's summary line, images/s)."""
    ckpt = os.path.join(tmp, "deploy.pt")
    deploy_weights(ckpt, device)
    runs = {dev: deploy_run(ckpt, dev, tmp)
            for dev in dict.fromkeys((device, "cpu"))}
    for dev, (results, summary) in runs.items():
        check(summary["images"] == 5 and summary["detections"] > 0,
              f"the deploy CLI on {dev}: {summary}")
    failed = deploy_scores_match(runs["cpu"][0], runs[device][0])
    check(not failed, f"deploy on {device} differs from its CPU run: "
          f"{failed[:2]}")
    moved = deploy_rows_match(runs["cpu"][0], runs[device][0])
    pinned = sum(min(len(r["detections"]), DEPLOY_TOP_ROWS)
                 for r in runs["cpu"][0])
    log(f"[12] deploy on {device} vs cpu: counts, top scores and OOD scores "
        f"within the golden's tolerances; {len(moved)} of {pinned} top rows "
        "of the CPU run matched by no row on the device (F3)")
    cpu = deploy_heads(ckpt, "cpu")
    gap = head_gap(deploy_heads(ckpt, device), cpu)
    floor = head_gap(cpu, deploy_heads(ckpt, "cpu", f64_sums=True))
    log(f"[12] deploy heads on {device} vs cpu: mean |difference| {gap[0]}, "
        f"share differing {gap[1]}; the CPU's f64 vs f32 conv sums: "
        f"{floor[0]}, {floor[1]}")
    check(floor[1] > 0 and gap[0] <= 1.25 * floor[0]
          and gap[1] <= 1.25 * floor[1],
          f"deploy heads on {device} vs cpu {gap} beyond 1.25 x {floor}")
    rate_dir = os.path.join(tmp, "deploy_rate")
    os.makedirs(rate_dir)
    jpegs = sorted(f for f in os.listdir(DEPLOY_FIXTURE)
                   if f.endswith(".jpg"))
    for i in range(copies):
        for f in jpegs:
            os.symlink(os.path.join(DEPLOY_FIXTURE, f),
                       os.path.join(rate_dir, f"{i}_{f}"))
    t0 = time.perf_counter()
    _, summary = deploy_run(ckpt, device, tmp, image_dir=rate_dir, batch=8)
    rate = len(jpegs) * copies / (time.perf_counter() - t0)
    log(f"[12] [{CARD}] deploy CLI on {device}: {rate} images/s over "
        f"{len(jpegs) * copies} images (batch 8, {summary['decoder']} "
        "decoder; the model build and loading included)")
    return runs[device][1], rate


def plain_path_compare(bench, pre, tag="[4]"):
    """The predict path's kernels against their plain versions on one
    letterboxed batch ``pre``: K2 (k2_compare) and the candidates it
    selects bit for bit (energies to rtol 1e-5), then K1's keep indices
    equal and detections to 1e-4 (soft-NMS). Returns (class outputs, box
    outputs, the kernel path's candidates, (img_scale, img_size), K1's
    score max abs error, K2's energy max abs error)."""
    num_classes = bench.config.num_classes
    cls, box = bench.model(pre["image"])
    err_k2 = k2_compare(cls, num_classes=num_classes)
    cand_k, cand_p = (pp.select_candidates(
        cls, box, bench.anchors, num_classes, 5000, "energy", kernels=k)
        for k in (True, False))
    # the selection is bit-exact; the energies agree to f32 summation order
    check(all(torch.equal(a, b) for a, b in zip(cand_k[:-1], cand_p[:-1])),
          f"{tag} candidates differ between K2 and its plain version")
    check(torch.allclose(cand_k.ood_all, cand_p.ood_all, rtol=1e-5,
                         atol=1e-5), f"{tag} energies differ beyond rtol 1e-5")
    info = (pre["img_scale"], pre["img_size"])
    dets_k, keep_k = pp.batch_detection(*cand_k[:4], *info, soft_nms=True,
                                        kernels=True)
    dets_p, keep_p = pp.batch_detection(*cand_p[:4], *info, soft_nms=True,
                                        kernels=False)
    sync_if(dets_k.is_cuda)
    check(torch.equal(keep_k, keep_p), f"{tag} keep indices differ")
    err_k1 = float((dets_k[..., 4] - dets_p[..., 4]).abs().max())
    check(torch.allclose(dets_k, dets_p, rtol=1e-4, atol=1e-4),
          f"{tag} detections differ between the kernel and plain paths")
    log(f"{tag} plain path on the same batch: equal candidates and keep "
        f"indices ({int((keep_k >= 0).sum())} kept), score max abs err "
        f"{err_k1:.3g}")
    return cls, box, cand_k, info, err_k1, err_k2


def breadth_predict(gen, device="cuda", img=BREADTH_IMG, batch=BATCH):
    """Phase 13 (a): BREADTH_MODEL (CSPResDet-50: CSPResNet-50 with
    leaky-ReLU, SiLU heads, plain 3 x 3 head convs, bilinear upsampling,
    aspect ratios (1, 2, 0.5)) at ``img`` px, 90 classes, bf16, soft-NMS,
    energy OOD, three class biases raised by 2, through
    ``create_model(..., bench_task="predict")``: 3 requests of ``batch``
    uint8 canvases (letterbox -> forward -> K2 -> top-k -> K1);
    on the card K2 and K1 once a request; finite outputs of their shapes
    with detections; the plain path on the last batch
    (plain_path_compare). Returns (the bench, the last batch's
    plain_path_compare result, the launches)."""
    on_card = torch.device(device).type == "cuda"
    bench = create_model(BREADTH_MODEL, bench_task="predict",
                         num_classes=NUM_CLASSES, soft_nms=True,
                         ood_method="energy", compute_dtype="bfloat16",
                         seed=0, device=device, image_size=(img, img))
    anchors = bench.model.config.num_anchors_per_location
    bench.model.class_net.predict_bias().view(anchors, NUM_CLASSES)[
        :, :3] += 2.0
    requests = 3
    reqs = [canvases(batch, gen, img=img, device=device)
            for _ in range(requests)]
    sync_if(on_card)
    reset_launches()
    for imgs, hw in reqs:
        pre = batched_letterbox_normalize(imgs, hw, target_hw=(img, img),
                                          out_dtype="bfloat16")
        dets, ood = bench(pre["image"], pre)
    sync_if(on_card)
    launches = launch_counts()
    if on_card:
        check(launches["K1"] == launches["K2"] == requests,
              f"[13] K1 and K2 must launch once a request: {launches}")
    check(tuple(dets.shape) == (batch, 100, 6)
          and tuple(ood.shape) == (batch, 100), "[13] output shapes")
    check(bool(torch.isfinite(dets).all()) and bool(torch.isfinite(ood).all()),
          "[13] non-finite outputs")
    n_det = int((dets[..., 4] > 0).sum())
    check(n_det > 0, "[13] no detections")
    log(f"[13] {BREADTH_MODEL}@{img} bf16 predict: {requests} requests x "
        f"{batch} images, launches {launches}, {n_det} detections in the "
        f"last ({bench.anchors.boxes.shape[0]} anchors)")
    return bench, plain_path_compare(bench, pre, tag="[13]"), launches


BREADTH_PRETRAIN_ARGS = (
    "--model", BREADTH_MODEL, "--num-classes", str(NUM_CLASSES),
    "--batch-size", str(BREADTH_TRAIN_BATCH), "--steps", "8", "--val-freq",
    "4", "--val-steps", "2", "--log-freq", "4", "--eval-map", "--workers",
    "4", "--mesh", "1")


def breadth_pretrain(tmp, device="cuda", extra=()):
    """Phase 13 (b): ``train.pretrain.main --model cspresdet50`` (f32, as
    its config says) on synthetic data, batch 16, 8 steps, validation of 2
    batches with --eval-map every 4 (``extra`` overrides flags): finite
    logged losses and val_mAP at each validation; on the card K3 / K4 once
    a train step and a val batch and K1 once a val batch. Then the
    logger's img_per_sec, the median step (CUDA events, timed_train_steps)
    and the peak memory. Returns (the final state, the logs, the step
    timer, the launches)."""
    on_card = torch.device(device).type == "cuda"
    argv = list(BREADTH_PRETRAIN_ARGS) + [
        "--device", device, "--checkpoint-dir", f"{tmp}/ck13",
        "--per-cat-dir", f"{tmp}/pc13"] + list(extra)
    args = pretrain.build_argparser().parse_args(argv)
    sync_if(on_card)
    reset_launches()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    with timed_train_steps(device) as timer:
        state, _, logs = run_driver(pretrain.main, argv, "[13] pretrain:")
    sync_if(on_card)
    launches = launch_counts()
    losses = [e for e in logs if "loss" in e]
    check(len(losses) == args.steps // args.log_freq and all(
        e[k] is not None and math.isfinite(e[k]) for e in losses
        for k in ("loss", "class_loss", "box_loss")),
        "[13] pretrain: a logged loss is missing or not finite")
    rounds = args.steps // args.val_freq
    maps = [e for e in logs if "val_mAP" in e]
    check([e["step"] for e in maps] == [args.val_freq * (i + 1)
                                        for i in range(rounds)]
          and all(math.isfinite(e["val_mAP"]) for e in maps),
          "[13] pretrain: val_mAP not logged, or not finite, at each "
          "validation")
    val_batches = rounds * args.val_steps
    if on_card:
        want = {"K1": val_batches, "K2": 0, "K3": args.steps + val_batches,
                "K4": args.steps + val_batches}
        check(launches == want,
              f"[13] pretrain: launches {launches}, not {want}")
    size = state.model.config.image_size[0]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 if on_card else 0.0
    rates = [e["img_per_sec"] for e in logs if "img_per_sec" in e]
    log(f"[13] [{CARD}] pretrain {BREADTH_MODEL}@{size} f32 "
        f"B={args.batch_size}: {args.steps} steps, {rounds} validations of "
        f"{args.val_steps} batches, launches {launches}; img_per_sec by log "
        f"step {rates}; median train step {timer.median * 1e3:.3f} ms (CUDA "
        f"events, {args.batch_size * 1e3 / (timer.median * 1e3):.2f} "
        f"images/s); peak memory {peak:.2f} GiB")
    return state, logs, timer, launches


@contextlib.contextmanager
def recorded_train_steps():
    """Every step function that ``train_state.make_train_step`` returns
    inside the block records its metrics (floats) a step, and after its
    first step the model's BatchNorm running statistics. Yields the
    record (``metrics``, ``stats``)."""
    record = SimpleNamespace(metrics=[], stats=None)
    make = train_state_mod.make_train_step

    def recording_make(*args, **kwargs):
        step_fn = make(*args, **kwargs)

        def recorded(state, batch):
            state, metrics = step_fn(state, batch)
            record.metrics.append({k: float(v) for k, v in metrics.items()})
            if record.stats is None:
                record.stats = {
                    n: b.detach().clone()
                    for n, b in state.model.named_buffers()
                    if n.endswith(("running_mean", "running_var"))}
            return state, metrics
        return recorded

    train_state_mod.make_train_step = recording_make
    try:
        yield record
    finally:
        train_state_mod.make_train_step = make


REMAT_ARGS = ("--model", REMAT_MODEL, "--num-classes", str(NUM_CLASSES),
              "--batch-size", str(REMAT_BATCH), "--steps", "3",
              "--val-freq", "1000", "--log-freq", "1", "--dropout", "0.2",
              "--workers", "2", "--mesh", "1")
REMAT_FLAGS = ("--remat", "3", "--remat-fpn-heads")


def remat_pair(tmp, device="cuda", extra=()):
    """Phase 13 (c): ``train.pretrain.main --model efficientdet_d4
    --dropout 0.2`` (f32, batch 4, 3 steps, no validation) twice from the
    same seed and data, plain and with ``--remat 3 --remat-fpn-heads``
    (``extra`` overrides flags). The first step's loss and grad_norm agree
    to 1e-5 relative, every BatchNorm running statistic after step 1 to
    1e-6, every step's loss is finite, and on the card K3 / K4 launch once
    a step and the rematted run's peak memory is lower. Returns {run:
    (record, peak GiB, final state, launches)}."""
    on_card = torch.device(device).type == "cuda"
    runs = {}
    for name, flags in (("plain", ()), ("remat", REMAT_FLAGS)):
        argv = list(REMAT_ARGS) + [
            "--device", device, "--checkpoint-dir", f"{tmp}/ck_{name}",
            "--per-cat-dir", f"{tmp}/pc_{name}"] + list(extra) + list(flags)
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        reset_launches()
        with recorded_train_steps() as record:
            state, _, logs = run_driver(pretrain.main, argv,
                                        f"[13] {name}:")
        sync_if(on_card)
        launches = launch_counts()
        if on_card:
            want = {"K1": 0, "K2": 0, "K3": 3, "K4": 3}
            check(launches == want,
                  f"[13] {name}: launches {launches}, not {want}")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30 if on_card \
            else 0.0
        check(len(record.metrics) == 3 and all(
            math.isfinite(m[k]) for m in record.metrics
            for k in ("loss", "grad_norm")),
            f"[13] {name}: a step's loss or grad_norm is not finite")
        cfg = state.model.config
        check(cfg.backbone_args.get("drop_path_rate") == 0.2
              and (cfg.remat_fpn, cfg.remat_heads,
                   cfg.backbone_args.get("remat_stages", 0))
              == ((True, True, 3) if flags else (False, False, 0)),
              f"[13] {name}: the flags did not reach the model config")
        runs[name] = (record, peak, state, launches)
    plain, remat = runs["plain"][0], runs["remat"][0]
    for key in ("loss", "grad_norm"):
        a, b = plain.metrics[0][key], remat.metrics[0][key]
        check(abs(a - b) <= 1e-5 * abs(a),
              f"[13] remat vs plain step 1 {key}: {b!r} vs {a!r}")
    stat_err = max(float((plain.stats[n] - remat.stats[n]).abs().max())
                   for n in plain.stats)
    check(all(torch.allclose(plain.stats[n], remat.stats[n], rtol=1e-6,
                             atol=1e-6) for n in plain.stats),
          f"[13] BatchNorm statistics after step 1 differ by {stat_err}")
    if on_card:
        check(runs["remat"][1] < runs["plain"][1],
              f"[13] remat peak {runs['remat'][1]} GiB is not below "
              f"{runs['plain'][1]} GiB")
    size = runs["plain"][2].model.config.image_size[0]
    log(f"[13] [{CARD}] {REMAT_MODEL}@{size} f32 B={REMAT_BATCH} "
        f"--dropout 0.2: step 1 loss {plain.metrics[0]['loss']!r} / "
        f"{remat.metrics[0]['loss']!r}, grad_norm "
        f"{plain.metrics[0]['grad_norm']!r} / "
        f"{remat.metrics[0]['grad_norm']!r} (plain / {' '.join(REMAT_FLAGS)}"
        f"); BatchNorm statistics after step 1 max abs diff {stat_err}; "
        f"peak memory {runs['plain'][1]:.2f} / {runs['remat'][1]:.2f} GiB; "
        f"launches {runs['plain'][3]} / {runs['remat'][3]}")
    return runs


def remat_kernels(gen, tag="[13]"):
    """K3 / K4 at REMAT_MODEL's 196,416 anchors on a batch of REMAT_BATCH
    images' ground truth, against their plain versions and timed beside
    their bounds (label_kernel_times)."""
    anchor_boxes = torch.from_numpy(Anchors.from_config(
        get_efficientdet_config(REMAT_MODEL)).boxes).cuda()
    boxes, cls = ground_truth(REMAT_BATCH, gen, img=REMAT_IMG)
    label_compare(anchor_boxes, boxes, cls, unmatched=0.5)
    return label_kernel_times(anchor_boxes, boxes, cls,
                              tag=f"{tag} [{CARD}]")


def zoo_sweep(gen, device="cuda", names=ZOO_SWEEP, batch=2):
    """Phase 13 (d): each zoo entry of ``names`` at full width and its
    published image size, 90 classes,
    bf16, soft-NMS, energy OOD, seed 0: built with create_model, then one
    request of ``batch`` uint8 canvases through letterbox -> forward -> K2
    -> K1 (on the card once each), finite outputs of their shapes; a
    second request for its warm time. Logs, an entry a line, the build
    seconds, both request times and the peak memory. Returns {name:
    (build s, cold ms, warm ms, peak GiB)}."""
    on_card = torch.device(device).type == "cuda"
    out = {}
    for name in names:
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        bench = create_model(name, bench_task="predict",
                             num_classes=NUM_CLASSES, soft_nms=True,
                             ood_method="energy", compute_dtype="bfloat16",
                             seed=0, device=device)
        sync_if(on_card)
        build_s = time.perf_counter() - t0
        size = bench.model.config.image_size[0]
        imgs, hw = canvases(batch, gen, img=size, device=device)

        def request():
            pre = batched_letterbox_normalize(imgs, hw,
                                              target_hw=(size, size),
                                              out_dtype="bfloat16")
            return bench(pre["image"], pre)

        def timed():
            t0 = time.perf_counter()
            out = request()
            sync_if(on_card)
            return out, (time.perf_counter() - t0) * 1e3

        reset_launches()
        (dets, ood), cold = timed()
        launches = launch_counts()
        (dets, ood), warm = timed()
        times = (cold, warm)
        if on_card:
            check(launches["K1"] == launches["K2"] == 1,
                  f"[13] {name}: K1 and K2 must launch once a request: "
                  f"{launches}")
        check(tuple(dets.shape) == (batch, 100, 6)
              and tuple(ood.shape) == (batch, 100)
              and bool(torch.isfinite(dets).all())
              and bool(torch.isfinite(ood).all()),
              f"[13] {name}: outputs not finite or of the wrong shapes")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30 if on_card \
            else 0.0
        out[name] = (build_s, times[0], times[1], peak)
        log(f"[13] [{CARD}] zoo {name}@{size} B={batch}: build "
            f"{build_s:.2f} s, request {times[0]:.2f} ms cold / "
            f"{times[1]:.2f} ms warm, peak memory {peak:.2f} GiB, "
            f"{bench.anchors.boxes.shape[0]} anchors, launches {launches}")
        del bench
    return out


def breadth_kernel_cases(gen):
    """Phase 3's cases at phase 13's shapes: K2 on random logits at
    BREADTH_IMG's levels (batch 16 and 64) and at REMAT_IMG's (a 128 x 128
    P3; batch 2 and REMAT_BATCH); K3 / K4 at REMAT_MODEL's 196,416 anchors
    with the train path's hazard rows (identical rows, a row that overlaps
    nothing, an all-padding image), batch REMAT_BATCH and
    BREADTH_TRAIN_BATCH, at unmatched 0.5 and 0.3."""
    for batch, img in ((BATCH, BREADTH_IMG), (64, BREADTH_IMG),
                       (2, REMAT_IMG), (REMAT_BATCH, REMAT_IMG)):
        err = k2_compare(random_logits(batch, gen, img=img))
        log(f"[3] K2 {img} px levels B={batch}: key bit-exact, energy max "
            f"abs err {err:.3g}")
    anchor_boxes = torch.from_numpy(Anchors.from_config(
        get_efficientdet_config(REMAT_MODEL)).boxes).cuda()
    check(anchor_boxes.shape[0] == REMAT_ANCHORS,
          f"{REMAT_MODEL}: {anchor_boxes.shape[0]} anchors")
    for batch in (REMAT_BATCH, BREADTH_TRAIN_BATCH):
        boxes, cls = ground_truth(batch, gen, cases=True, img=REMAT_IMG)
        for unmatched in (0.5, 0.3):
            _, err, codes, (_, _, best) = label_compare(
                anchor_boxes, boxes, cls, unmatched)
            check(bool((codes[1] == -1).all())
                  and int(best[0, 0]) == int(best[0, 1])
                  and int(codes[0, best[0, 0]]) == 0
                  and int(best[0, 2]) == 0 and int(codes[0, 0]) == 2,
                  f"K3 / K4 at {REMAT_ANCHORS} anchors: the hazard rows")
            log(f"[3] K3 / K4 [{batch}, {MAX_ROWS}] x {REMAT_ANCHORS} "
                f"anchors, unmatched {unmatched}: match and codes "
                f"bit-exact, box max abs err {err:.3g}")


def main(argv=()):
    """Every phase (no arguments), or with ``--cards`` phases 1, 2, 14 (e)
    and 16's four-card part alone, on a machine with two cards or
    more."""
    if list(argv) not in ([], ["--cards"]):
        print(f"chip_smoke: unknown arguments {argv}", file=sys.stderr)
        return 2
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
    if argv:
        check(torch.cuda.device_count() >= 2, "--cards needs two cards")
        torch.backends.cudnn.allow_tf32 = True     # as phases 10-14
        with tempfile.TemporaryDirectory() as tmp:
            data_parallel_cards(tmp, torch.cuda.device_count())
            spatial_cards(tmp, torch.cuda.device_count())
        print(smi)
        return 0

    # 3. kernels vs plain versions on the card
    gen = torch.Generator(device="cuda").manual_seed(0)
    anchor_boxes, label_inputs, err_match = kernel_cases(gen)

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
    cls, box, cand_k, info, err_k1, err_k2 = plain_path_compare(bench, pre)

    # 5. times: the kernels at the main path's shapes (batch 16) and at
    #    batch 128, end to end at both; card as printed above
    t = kernel_times(cand_k, cls, info)
    busy = {}
    for batch in (BATCH, 128):
        busy["predict"] = throughput(bench, batch, gen)["busy_ms"] / 1e3
    sync()
    del bench, cls, box, requests, cand_k
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
        update_kernel_times(train[0].model, train[1].ema_params)
        for batch in (TRAIN_BATCH, 128):
            busy["train"] = train_throughput(*train[:5], batch,
                                             gen)["busy_ms"] / 1e3
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
        val_metrics = metrics
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

    # 12. the serving path: D0@512 bf16 exported once (uint8 canvases in,
    #     a symbolic batch), saved, loaded and served at 1, 8 and 16
    #     images, equal to the live path, K2 and K1 once a call; images/s
    #     of the artifact and the live path; the card-exported artifact on
    #     the CPU; the deploy CLI on the card against its CPU run
    t0 = time.time()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        bench, module, path, _, _ = serving_path(tmp, gen)
        serving_rate(bench, module, gen)
        del bench, module
        torch.cuda.empty_cache()
        artifact_on_cpu(path, gen)
        deploy_path(tmp)
    sync()
    log(f"[12] phase 12 took {time.time() - t0:.1f} s")

    # 13. model breadth: CSPResDet-50@640 bf16 predict (K2 -> K1) and its
    #     pretrain CLI (K3 -> K4 -> K1), the EfficientDet-D4@1024 remat
    #     pair with stochastic depth, and one request of each zoo entry the
    #     port builds since this phase came in
    t0 = time.time()
    torch.cuda.empty_cache()
    bench, (cls, _, cand, info, _, _), _ = breadth_predict(gen)
    kernel_times(cand, cls, info, tag="[13]")
    for batch in BREADTH_RATE_BATCHES:
        throughput(bench, batch, gen, img=BREADTH_IMG, tag="[13]")
    sync()
    del bench, cls, cand
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp, torch.enable_grad():
        breadth_pretrain(tmp)
        torch.cuda.empty_cache()
        remat_pair(tmp)
    torch.cuda.empty_cache()
    remat_kernels(gen)
    zoo_sweep(gen)
    sync()
    log(f"[13] phase 13 took {time.time() - t0:.1f} s")

    # 14. data parallelism: the pretrain CLI, validate and the meta driver
    #     as ranks of torchrun (two on this card over gloo, one over NCCL),
    #     each held against one process; across cards where there are;
    # 15. the two examples at their defaults (D0, 256 px, 500 steps, f32),
    #     their processes started before phase 14 and run beside it (the
    #     script's time limit: each phase waits on its own processes)
    t0 = time.time()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp15:
        started = start_examples(tmp15, examples_argvs(tmp15))
        try:
            with tempfile.TemporaryDirectory() as tmp:
                data_parallel(tmp, validate_metrics=val_metrics)
        except BaseException:
            stop_examples(started)
            raise
        log(f"[14] phase 14 took {time.time() - t0:.1f} s (beside phase "
            f"15's two example processes)")
        t14 = time.time()
        with torch.enable_grad():
            examples_path(tmp15, started=started)
    example_kernels()
    sync()
    log(f"[15] phase 15 took {time.time() - t0:.1f} s from its start "
        f"beside phase 14, {time.time() - t14:.1f} s after it")

    # 16. the spatial leg: two gloo ranks on this card split D0@512's rows
    #     as a (1, 2) mesh, against one process; across cards where there
    #     are four
    t0 = time.time()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        spatial_path(tmp)
    log(f"[16] phase 16 took {time.time() - t0:.1f} s")

    # 17. the benchmark entry point: run_bench's default run, meta and
    #     loader modes and CLI, its rows held under the card's busy time
    #     of phases 5 and 7; the roofline tools
    t0 = time.time()
    torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32 = True         # as a user runs it
    with tempfile.TemporaryDirectory() as tmp:
        bench_path(tmp, busy=busy)
    sync()
    log(f"[17] phase 17 took {time.time() - t0:.1f} s")

    # 18. published weights from the cache (pretrained=True, nothing
    #     fetched) and a timm training checkpoint's EMA copy, through the
    #     package's top-level names: 3 requests of 16 through K2 and K1
    torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32 = False        # as phase 4
    with tempfile.TemporaryDirectory() as tmp:
        launches18, _, _ = pretrained_path(tmp, gen)
    for name in ("K1", "K2"):
        launches[name] += launches18[name]

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


def kernel_cases(gen, tag="[3]"):
    """Phase 3: each kernel against its plain version on the current card
    (the cases of the module's docstring). Returns (D0@512's anchor boxes
    on the card, the batch-32 and batch-128 ground truth, K3's largest
    error at batch 32)."""
    for batch in (BATCH, 128):
        for name, make in (("tied", tied_logits), ("random", random_logits)):
            err = k2_compare(make(batch, gen))
            log(f"{tag} K2 {name} B={batch}: key bit-exact, energy max abs err "
                f"{err:.3g}")
    levels = tied_logits(3, gen, img=128)
    plan = cuda_reduce.tile_plan([lvl.shape for lvl in levels], NUM_CLASSES)
    check(plan.rows[-1] == 27 and not list(cuda_reduce.plan_tiles(plan))[-1][4],
          "D0@128 at batch 3 must end on a ragged tile")
    err = k2_compare(levels)
    k2_compare(levels, energy=False)
    k2_compare(tied_logits(BATCH, gen), energy=False)
    log(f"{tag} K2 D0@128 B=3 (ragged last tile, P7 27 rows): key bit-exact, "
        f"energy max abs err {err:.3g}; energy=False at B=3 and {BATCH}: "
        "key bit-exact")
    for c in (20, 21):   # the kernel's 32-bit (even C) and 16-bit (odd) reads
        err = k2_compare([
            (torch.randn((2, 16 >> lvl, 16 >> lvl, 9 * c), generator=gen,
                         device="cuda") * 2.0 - 3.0).to(torch.bfloat16)
            for lvl in range(3)], num_classes=c)
        log(f"{tag} K2 C={c}: key bit-exact, energy max abs err {err:.3g}")
    for batch, n in ((BATCH, 5000), (128, 5000), (2, 1001),
                     (VAL_BATCH, 5000), (VAL_IMAGES % VAL_BATCH, 5000)):
        boxes, scores = random_nms_inputs(batch, n, gen)
        chosen = cuda_nms.device_cluster_size(torch.cuda.current_device(),
                                              batch, n)
        for soft in (False, True):
            errs = [k1_compare(boxes, scores, soft, cluster=c)
                    for c in (None,) + cuda_nms.CLUSTER_SIZES]
            log(f"{tag} K1 [{batch}, {n}] soft={soft}: keep equal at the "
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
            log(f"{tag} K3 / K4 [{batch}, {MAX_ROWS}] x {anchor_boxes.shape[0]}"
                f" anchors, unmatched {unmatched}: match and codes "
                f"bit-exact, class targets equal, box max abs err {err:.3g}"
                f", {int((codes == -2).sum())} ignored")
            if batch == TRAIN_BATCH:
                err_match = err_k3
    label_hazards(anchor_boxes, gen)
    meta_kernel_cases(gen)
    breadth_kernel_cases(gen)
    sync()
    return anchor_boxes, label_inputs, err_match


def reset_launches():
    """Every kernel's launch count to 0 (before a path is driven)."""
    for fn in (cuda_nms.batched_nms, cuda_reduce.key_energy_reduce,
               cuda_labeler.batch_match, cuda_labeler.batch_codes_targets,
               cuda_update.global_norm_clip_, cuda_update.ema_update_):
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
    # the profiler mirrors each of the program's spans (``odt.*``) onto the
    # card's timeline as a user annotation, which is no device work
    device = [e for e in events if e.device_type == DeviceType.CUDA
              and not e.is_user_annotation]
    check(len(device) > 0, "the profiler recorded no device activity")
    issued = collections.Counter(
        e.name for e in events
        if e.device_type == DeviceType.CPU and e.name.startswith(RUNTIME_OPS))
    busy = busy_ms(device) / reps
    return dict(wall_ms=wall, busy_ms=busy, idle=1.0 - busy / wall,
                ops=len(device) / reps,
                issued=sum(issued.values()) / reps), device, issued


def throughput(bench, batch, gen, img=IMG, tag="[5]"):
    """End to end at ``batch`` over ``img`` px uint8 canvases already on
    the card; logged under ``tag``.
    Requests (preproc -> forward -> post-process, each ending in a
    synchronise) run until WINDOW_S seconds have passed: images/s over the
    window, and the median, least and most request time. Then a profiler
    window of the whole request and of each stage alone (profile_window),
    and the kernels with the most device time in a request. At batches
    other than the main path's, also the kernels' times on this batch.
    Returns the request's profile_window numbers."""
    imgs, hw = canvases(batch, gen, img=img)
    num_classes = bench.config.num_classes

    def preproc():
        return batched_letterbox_normalize(imgs, hw, target_hw=(img, img),
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
    log(f"{tag} [{CARD}] end to end B={batch}: "
        f"{batch * len(times) * 1e3 / sum(times)}"
        f" images/s over {len(times)} requests; request ms median "
        f"{times[len(times) // 2]}, min {times[0]}, max {times[-1]}")

    pre = preproc()
    cls, box = bench.model(pre["image"])
    stages = {
        "request": request,
        "preproc": preproc,
        "forward": lambda: bench.model(pre["image"]),
        "post": lambda: pp.generate_detections(
            cls, box, bench.anchors, num_classes, img_scale=pre["img_scale"],
            img_size=pre["img_size"], soft_nms=True, ood_method="energy"),
    }
    top = collections.Counter()
    for name, fn in stages.items():
        numbers, device, _ = profile_window(fn)
        log(f"{tag} profile B={batch} {name}: " + ", ".join(
            f"{k} {v}" for k, v in numbers.items()))
        if name == "request":
            request = numbers
            for e in device:
                top[e.name[:80]] += (e.time_range.end - e.time_range.start
                                     ) / 1e3 / PROFILE_REPS
    for name, ms in top.most_common(10):
        log(f"{tag} top kernel B={batch}: {ms:.4f} ms {name}")
    if batch != BATCH:
        kernel_times(pp.select_candidates(cls, box, bench.anchors,
                                          num_classes, 5000, "energy"), cls,
                     (pre["img_scale"], pre["img_size"]), tag=tag)
    return request


# ---------------------------------------------------------------------------
# 14. data parallelism: ranked runs of the entry points under torchrun

def torchrun(nproc, spec, tag, timeout=600):
    """Run ``spec``'s rank drive (``rank_main``) as ``nproc`` processes of
    ``python -m torch.distributed.run`` on this host, in a subprocess.
    Returns each rank's result (``{out}/rank<r>.json``, rank order); fails
    with the tail of the ranks' logs if the launch fails."""
    out = spec["out"]
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    t0 = time.time()
    # every rank is on this host: the groups' sockets on the loopback
    env = {"GLOO_SOCKET_IFNAME": "lo", "NCCL_SOCKET_IFNAME": "lo",
           **os.environ}
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(nproc), os.path.abspath(__file__),
         "--rank", json.dumps(spec)], capture_output=True, text=True,
        timeout=timeout, env=env)
    if proc.returncode:
        for r in range(nproc):
            path = f"{out}/rank{r}.log"
            if os.path.exists(path):
                for line in open(path).read().splitlines()[-15:]:
                    log(f"{tag} rank {r}: {line}")
        for line in proc.stderr.splitlines()[-30:]:
            log(f"{tag} torchrun: {line}")
        check(False, f"{tag} torchrun of {nproc} ranks ({spec['drive']}) "
              f"exited {proc.returncode}")
    results = [json.load(open(f"{out}/rank{r}.json")) for r in range(nproc)]
    log(f"{tag} {nproc} ranks of {spec['drive']} ({spec.get('backend')}, "
        f"{spec['device']}) took {time.time() - t0:.1f} s")
    return results


def rank_main(spec):
    """One rank of a phase-14 or 16 launch (``chip_smoke.py --rank <spec>``,
    started by torchrun): the drive ``spec['drive']`` with this script's
    prints in ``{out}/rank<r>.log`` and its result in
    ``{out}/rank<r>.json``."""
    spec = json.loads(spec)
    rank = int(os.environ["RANK"])
    torch.backends.cudnn.allow_tf32 = spec.get("tf32", True)
    torch.backends.cuda.matmul.allow_tf32 = False
    global CARD
    CARD = spec.get("card", CARD)
    with open(f"{spec['out']}/rank{rank}.log", "w") as f, \
            contextlib.redirect_stdout(f):
        try:
            result = RANK_DRIVES[spec["drive"]](spec)
        except BaseException:
            traceback.print_exc(file=f)
            raise
    result["rank"] = rank
    with open(f"{spec['out']}/rank{rank}.json", "w") as f:
        json.dump(result, f)
    return 0


def dp_batch(batch, img, classes, seed=14):
    """A global train batch made on the host from ``seed``: normal images
    and 16 boxes an image (synthetic_boxes), padded to MAX_ROWS."""
    rng = np.random.default_rng(seed)
    boxes = np.zeros((batch, MAX_ROWS, 4), np.float32)
    cls = np.full((batch, MAX_ROWS), -1, np.int32)
    for i in range(batch):
        boxes[i, :16] = synthetic_boxes(rng, 16, img)
        cls[i, :16] = rng.integers(1, classes + 1, 16)
    return {"image": torch.from_numpy(rng.normal(
                0, 1, (batch, img, img, 3)).astype(np.float32)),
            "bbox": torch.from_numpy(boxes), "cls": torch.from_numpy(cls)}


@contextlib.contextmanager
def no_tf32():
    """cuDNN's f32 convolutions in f32 (TF32 off) inside the block."""
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = saved


def dp_train_setup(device, img, classes, overrides, batch,
                   model="efficientdet_d0"):
    """The train path of phases 14 and 16 through the user's entry
    points: ``model`` (D0) at ``img`` (f32, seed 0), its train state and
    the global batch."""
    bench = create_model(model, bench_task="train",
                         num_classes=classes, seed=0, device=device,
                         image_size=(img, img), **overrides)
    tcfg = default_detection_train_config()
    state, tx = create_train_state(bench, tcfg)
    return bench, state, tx, tcfg, dp_batch(batch, img, classes)


def collective_window(step, state, local, steps, on_card):
    """Time ``steps`` train steps, then profile as many: (ms a step, per
    step, from the window's spans: the ``all_reduce_sum`` collectives
    (``odt.mesh.all_reduce``: the synced BatchNorm's,
    forward and backward, the positives', the losses' and the
    gradient's) and their host ms, the gradient all-reduce's share of it,
    the NCCL kernels' device ms, which include their wait for the slowest
    rank; where the step makes them, the spatial group's exchanges by
    kind and their host ms)."""
    sync_if(on_card)
    t0 = time.perf_counter()
    for _ in range(steps):
        state, _ = step(state, local)
    sync_if(on_card)
    step_ms = (time.perf_counter() - t0) * 1e3 / steps
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if on_card else [])
    with profile(activities=activities) as prof:
        for _ in range(steps):
            state, _ = step(state, local)
        sync_if(on_card)
    spans = {k: [0, 0.0] for k in ("odt.mesh.all_reduce",
                                    "odt.mesh.grad_all_reduce",
                                    "odt.spatial.halo", "odt.spatial.gather",
                                    "odt.spatial.se_sum")}
    device = 0.0
    for e in prof.key_averages():
        if e.key in spans and e.device_type == DeviceType.CPU:
            spans[e.key][0] += e.count
            spans[e.key][1] += e.cpu_time_total / 1e3
        elif "nccl" in e.key.lower() and e.device_type == DeviceType.CUDA:
            device += e.self_device_time_total / 1e3
    window = {
        "allreduces": spans["odt.mesh.all_reduce"][0] / steps,
        "allreduce_host_ms": round(spans["odt.mesh.all_reduce"][1] / steps,
                                   3),
        "of_it_gradient_ms": round(
            spans["odt.mesh.grad_all_reduce"][1] / steps, 3),
        "nccl_kernel_ms": round(device / steps, 3)}
    # the spatial group's exchanges (phase 16), where the step makes them
    for kind in ("halo", "gather", "se_sum"):
        count, ms = spans[f"odt.spatial.{kind}"]
        if count:
            window[f"{kind}s"] = count / steps
            window[f"{kind}_host_ms"] = round(ms / steps, 3)
    return step_ms, window


def rank_dp_pretrain(spec):
    """Drive (a) on one rank: the data-parallel train step on this rank's
    rows of a global batch, TF32 off (metrics, parameters and collectives
    saved for the comparison with one process), its collective window
    with TF32 as the launch has it, then the
    pretrain CLI with validation and --eval-map (logs, launches, writes of
    a checkpoint file); with ``spec['kernels']`` first phase 3's kernel
    cases on this rank's card."""
    from ood_object_detection_tpu_torch.parallel import create_mesh
    mesh = create_mesh((-1,), ("data",), device=spec["device"],
                       backend=spec["backend"])
    on_card = mesh.device.type == "cuda"
    result = {"device": str(mesh.device), "world": mesh.size}
    if spec.get("kernels"):
        kernel_cases(torch.Generator(device="cuda").manual_seed(mesh.rank))
        result["kernel_cases"] = "passed"
    if spec.get("step", True):
        result.update(dp_step_rank(spec, mesh))
    if spec.get("cli"):
        result.update(dp_cli_rank(spec, on_card))
    mesh.close()
    return result


def dp_step_rank(spec, mesh):
    """Drive (a)'s step 1 and collective window on one rank (see
    rank_dp_pretrain)."""
    from ood_object_detection_tpu_torch.parallel import shard_batch
    from ood_object_detection_tpu_torch.parallel.mesh import all_reduce_sum
    on_card = mesh.device.type == "cuda"
    result = {}
    img, classes = spec["img"], spec["classes"]
    bench, state, tx, tcfg, batch = dp_train_setup(
        mesh.device, img, classes, spec["overrides"],
        spec["batch"] * mesh.size)
    step = make_train_step(bench, tx, Anchors.from_config(bench.config),
                           tcfg, mesh=mesh, freeze_bn="backbone")
    local = shard_batch(mesh, batch)
    with torch.enable_grad():
        sync_if(on_card)
        reset_launches()
        all_reduce_sum.calls = 0
        with no_tf32():
            state, metrics = step(state, local)
        sync_if(on_card)
        result["step1"] = {k: float(v) for k, v in metrics.items()}
        result["step1_collectives"] = all_reduce_sum.calls
        result["step1_launches"] = launch_counts()
        torch.save({n: p.detach().cpu()
                    for n, p in bench.model.named_parameters()},
                   f"{spec['out']}/params{mesh.rank}.pt")
        state, _ = step(state, local)           # warm-up with TF32 on
        step_ms, window = collective_window(step, state, local,
                                            spec["window"], on_card)
    result["step_ms"], result["window"] = step_ms, window
    del bench, state, tx, batch, local
    if on_card:
        torch.cuda.empty_cache()
    return result


def dp_cli_rank(spec, on_card):
    """Drive (a)'s pretrain CLI on one rank: its logs, launches,
    collectives and the checkpoint files this rank wrote."""
    from ood_object_detection_tpu_torch.parallel.mesh import all_reduce_sum
    from ood_object_detection_tpu_torch.train import checkpoint as ckpt_mod
    writes = []
    write = ckpt_mod._write

    def counted_write(path, payload):
        writes.append(os.path.basename(path))
        write(path, payload)
    ckpt_mod._write = counted_write
    reset_launches()
    all_reduce_sum.calls = 0
    try:
        with torch.enable_grad():
            _, _, logs = run_driver(pretrain.main, spec["cli"],
                                    "[14] pretrain:")
    finally:
        ckpt_mod._write = write
    sync_if(on_card)
    return dict(cli_logs=logs, cli_launches=launch_counts(),
                cli_collectives=all_reduce_sum.calls, ckpt_writes=writes)


def rank_dp_validate(spec):
    """Drive (c) on one rank: ``validate.main --mesh N`` (metrics, K1 /
    K2 launches, this rank's batches), then the ground truth as
    detections through the distributed evaluators (the oracle)."""
    from ood_object_detection_tpu_torch.parallel import create_mesh
    mesh = create_mesh((-1,), ("data",), device=spec["device"],
                       backend=spec["backend"])
    on_card = mesh.device.type == "cuda"
    reset_launches()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        metrics = validate.main(spec["argv"])
    sync_if(on_card)
    launches = {"K1": cuda_nms.batched_nms.launches,
                "K2": cuda_reduce.key_energy_reduce.launches}
    args = validate.build_argparser().parse_args(spec["argv"])
    cfg = get_efficientdet_config("efficientdet_d0").replace(
        num_classes=NUM_CLASSES, image_size=(spec["img"], spec["img"]))
    loader = validate.make_val_loader(args, cfg, mesh.device, mesh)
    oracle = {"coco": CocoEvaluator(NUM_CLASSES, distributed=True),
              "pascal": PascalEvaluator(NUM_CLASSES, distributed=True)}
    rows = []
    for b in loader:
        rows.append(int(b["image"].shape[0]) if b else 0)
        gt = target = None
        if b:
            target = {k: b[k] for k in ("bbox", "cls", "img_id")}
            gt = torch.cat([b["bbox"][..., [1, 0, 3, 2]],
                            torch.ones_like(b["cls"][..., None],
                                            dtype=torch.float32),
                            b["cls"][..., None].to(torch.float32)], dim=-1)
            gt = torch.where((b["cls"] > 0)[..., None], gt,
                             torch.zeros_like(gt))
        for ev in oracle.values():
            ev.add_predictions(gt, target)
    ap = {"coco": oracle["coco"].evaluate()["map"],
          "pascal": oracle["pascal"].evaluate()["mAP@0.5IOU"]}
    mesh.close()
    return {"metrics": metrics, "printed": out.getvalue().strip(),
            "launches": launches, "rows": rows, "oracle": ap}


def meta_dp_episodes(trainer, builder, colors, device, count):
    """``count`` synthetic episodes (phase 8's) built from fixed seeds, the
    same on every process that builds them on the same kind of card."""
    import random
    random.seed(14)          # the projection crops' jitter
    rng = np.random.default_rng(14)
    gen = torch.Generator(device=device).manual_seed(14)
    return [builder.build(*synthetic_episode(trainer.meta_cfg, rng, gen,
                                             colors, trainer.device))
            for _ in range(count)]


def rank_dp_meta(spec):
    """Drive (d) on one rank: the meta driver with --episode-mesh N at its
    defaults (logs, launches, episodes built, final meta parameters),
    then one meta update of ``make_sharded_meta_step`` on this rank's
    share of a meta batch of phase-8 episodes (nesterov)."""
    from ood_object_detection_tpu_torch.parallel import create_mesh
    mesh = create_mesh((-1,), ("episode",), device=spec["device"],
                       backend=spec["backend"])
    on_card = mesh.device.type == "cuda"
    calls = {}
    reset_launches()
    with counted(EpisodeBuilder, "build", calls), torch.enable_grad():
        trainer, _, logs = run_driver(train_driver.main, spec["driver"],
                                      "[14] meta driver:")
    sync_if(on_card)
    result = {"driver_logs": logs, "driver_launches": launch_counts(),
              "builds": calls["build"]}
    torch.save(_cpu(trainer.meta_params),
               f"{spec['out']}/driver_meta{mesh.rank}.pt")
    del trainer
    meta_cfg = MetaConfig(optim="nesterov", **spec["meta_kw"])
    trainer, builder, colors = meta_setup(
        torch.Generator(device=mesh.device).manual_seed(0),
        device=mesh.device, meta_cfg=meta_cfg, **spec["overrides"])
    episodes = meta_dp_episodes(trainer, builder, colors, mesh.device,
                                meta_cfg.meta_batch_size)
    per = meta_cfg.meta_batch_size // mesh.size
    with torch.enable_grad():
        metrics = trainer.train_meta_batch_sharded(
            episodes[mesh.rank * per:(mesh.rank + 1) * per], mesh)
    sync_if(on_card)
    torch.save(_cpu(trainer.meta_params),
               f"{spec['out']}/sharded_meta{mesh.rank}.pt")
    result["sharded_metrics"] = {k: float(v) for k, v in metrics.items()}
    mesh.close()
    return result


def _cpu(tree):
    return {t: {n: v.detach().cpu() for n, v in d.items()}
            for t, d in tree.items()}


def rank_dp_rate(spec):
    """(e) on one rank: the data-parallel train step at ``spec['batch']``
    images a rank, its time a step and its collective window."""
    from ood_object_detection_tpu_torch.parallel import (create_mesh,
                                                         shard_batch)
    mesh = create_mesh((-1,), ("data",), device=spec["device"],
                       backend=spec["backend"])
    bench, state, tx, tcfg, batch = dp_train_setup(
        mesh.device, spec["img"], spec["classes"], spec["overrides"],
        spec["batch"] * mesh.size)
    step = make_train_step(bench, tx, Anchors.from_config(bench.config),
                           tcfg, mesh=mesh, freeze_bn="backbone")
    local = shard_batch(mesh, batch)
    on_card = mesh.device.type == "cuda"
    with torch.enable_grad():
        for _ in range(2):                      # warm-up
            state, _ = step(state, local)
        step_ms, window = collective_window(step, state, local,
                                            spec["window"], on_card)
    mesh.close()
    return {"step_ms": step_ms, "window": window, "peak_gib":
            torch.cuda.max_memory_allocated() / 2 ** 30 if on_card else 0.0}


def rank_spatial(spec):
    """Phase 16 on one rank: ``spec['model']`` at ``spec['img']`` on a 2-D
    (data, spatial) mesh of shape ``spec['mesh']``, f32 with TF32 off,
    ``freeze_bn='none'``: step 1 of ``make_train_step(...,
    spatial_axis='spatial')`` on this rank's data block of a global batch
    of ``spec['batch']`` (metrics, launches, the spatial group's exchanges,
    the collectives, the peak device memory above what the step began
    with, the parameters saved unless ``spec['save']`` is False), then
    ``spec['steps']`` steps timed (ms a step, launches, the exchanges a
    step) and a profiler window of one step (the collectives and the
    exchanges a step and their host ms: ``collective_window``)."""
    from ood_object_detection_tpu_torch.parallel import (create_mesh,
                                                         shard_batch, spatial)
    from ood_object_detection_tpu_torch.parallel.mesh import all_reduce_sum
    mesh = create_mesh(tuple(spec["mesh"]), ("data", "spatial"),
                       device=spec["device"], backend=spec["backend"])
    on_card = mesh.device.type == "cuda"
    bench, state, tx, tcfg, batch = dp_train_setup(
        mesh.device, spec["img"], spec["classes"], spec["overrides"],
        spec["batch"], spec["model"])
    step = make_train_step(bench, tx, Anchors.from_config(bench.config),
                           tcfg, mesh=mesh, freeze_bn="none",
                           spatial_axis="spatial")
    local = shard_batch(mesh, batch)
    result = {"device": str(mesh.device), "shape": mesh.shape}
    with torch.enable_grad(), no_tf32():
        sync_if(on_card)
        start = 0
        if on_card:
            torch.cuda.reset_peak_memory_stats()
            start = torch.cuda.memory_allocated()
        reset_launches()
        spatial.reset_exchanges()
        all_reduce_sum.calls = 0
        state, metrics = step(state, local)
        sync_if(on_card)
        result.update(
            step1={k: float(v) for k, v in metrics.items()},
            step1_launches=launch_counts(),
            step1_exchanges=dict(spatial.EXCHANGES),
            step1_collectives=all_reduce_sum.calls)
        if on_card:
            result["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
            result["step_peak_gib"] = (torch.cuda.max_memory_allocated()
                                       - start) / 2 ** 30
        if spec.get("save", True):
            torch.save({n: p.detach().cpu()
                        for n, p in bench.model.named_parameters()},
                       f"{spec['out']}/params{mesh.rank}.pt")
        steps = spec["steps"]
        if steps:
            reset_launches()
            spatial.reset_exchanges()
            t0 = time.perf_counter()
            for _ in range(steps):
                state, metrics = step(state, local)
            sync_if(on_card)
            result.update(
                step_ms=(time.perf_counter() - t0) * 1e3 / steps,
                launches=launch_counts(),
                exchanges={k: v / steps
                           for k, v in spatial.EXCHANGES.items()},
                last={k: float(v) for k, v in metrics.items()})
            _, result["window"] = collective_window(step, state, local, 1,
                                                    on_card)
    mesh.close()
    return result


RANK_DRIVES = {"pretrain": rank_dp_pretrain, "validate": rank_dp_validate,
               "meta": rank_dp_meta, "rate": rank_dp_rate,
               "spatial": rank_spatial}


def params_close(got, want, before, rtol=5e-4, atol=1e-5):
    """Two parameter dicts after one step from ``before``: (the largest
    |got - want| - atol - rtol |want| (<= 0: within the tolerance), its
    parameter, the elements beyond it, the difference of the two updates
    in relative L2)."""
    worst, over, diff, norm = (-math.inf, None), 0, 0.0, 0.0
    for n, w in want.items():
        excess = (got[n] - w).abs() - atol - rtol * w.abs()
        worst = max(worst, (float(excess.max()), n))
        over += int((excess > 0).sum())
        diff += float(((got[n] - w) ** 2).sum())
        norm += float(((w - before[n]) ** 2).sum())
    return worst[0], worst[1], over, math.sqrt(diff / norm)


def one_process_steps(device, img, classes, overrides, batch, freeze_bn,
                      model="efficientdet_d0"):
    """Step 1 of one process on the global batch and again on it in
    reverse order, f32 with cuDNN's TF32 off: ([(metrics, parameters)]
    of the two, the parameters before, the first step's peak device GiB
    above what was allocated when it began (0 on the CPU))."""
    on_card = torch.device(device).type == "cuda"
    runs, peak = [], 0.0
    with no_tf32():
        for reverse in (False, True):
            bench, state, tx, tcfg, gbatch = dp_train_setup(
                device, img, classes, overrides, batch, model)
            before = {n: p.detach().cpu().clone()
                      for n, p in bench.model.named_parameters()}
            step = make_train_step(bench, tx, Anchors.from_config(
                bench.config), tcfg, freeze_bn=freeze_bn)
            gbatch = {k: (v.flip(0) if reverse else v).to(device)
                      for k, v in gbatch.items()}
            if on_card:
                sync()
                torch.cuda.reset_peak_memory_stats()
                start = torch.cuda.memory_allocated()
            with torch.enable_grad():
                _, metrics = step(state, gbatch)
            sync_if(on_card)
            if on_card and not reverse:
                peak = (torch.cuda.max_memory_allocated() - start) / 2 ** 30
            runs.append(({k: float(v) for k, v in metrics.items()},
                         {n: p.detach().cpu().clone()
                          for n, p in bench.model.named_parameters()}))
            del bench, state, tx, gbatch
    return runs, before, peak


def hold_step1(tag, out, ranks, runs, before, on_card):
    """Phase 14 (a)'s bars for the ranks' step 1 (``{out}/params<r>.pt``)
    against one process's (``one_process_steps``): losses and grad_norm
    to rtol 2e-4, num_positives exactly, the update's relative L2
    difference at most 3 times (and 1e-5 at least) what one process's
    moves on the batch reversed; K3 / K4 once each on the card. Returns
    (one process's metrics, the update's bound)."""
    (want, ref), (reversed_metrics, reversed_params) = runs
    floor = params_close(reversed_params, ref, before)
    gaps = [params_close(torch.load(f"{out}/params{r}.pt"), ref, before)
            for r in range(len(ranks))]
    log(f"{tag} step 1 (f32, TF32 off), one process: {want}; the batch "
        f"reversed: {reversed_metrics}; by rank: "
        f"{[r['step1'] for r in ranks]}")
    log(f"{tag} parameters after step 1 against one process's (the largest "
        "excess over rtol 5e-4 / atol 1e-5, its parameter, the elements "
        "beyond, the updates' relative L2 difference): one process on the "
        f"batch reversed {floor}; by rank {gaps}")
    bound = max(3 * floor[3], 1e-5)
    for r, res in enumerate(ranks):
        got = res["step1"]
        for k in ("loss", "class_loss", "box_loss", "grad_norm"):
            check(abs(got[k] - want[k]) <= 2e-4 * abs(want[k]),
                  f"{tag} rank {r} step 1 {k} {got[k]} vs one process "
                  f"{want[k]}")
        check(got["num_positives"] == want["num_positives"],
              f"{tag} rank {r} num_positives {got['num_positives']} vs "
              f"{want['num_positives']}")
        check(gaps[r][3] <= bound, f"{tag} rank {r}: the update differs "
              f"from one process's by {gaps[r][3]:.3g} (relative L2), "
              f"beyond {bound:.3g}")
        if on_card:
            check(res["step1_launches"]["K3"] == res["step1_launches"]["K4"]
                  == 1, f"{tag} rank {r} step launches "
                  f"{res['step1_launches']}")
    return want, bound


def dp_pretrain_path(tmp, device="cuda:0", backend="gloo", nproc=2,
                     img=IMG, classes=NUM_CLASSES, batch=DP_BATCH,
                     overrides=None, steps=DP_STEPS, val_freq=DP_VAL_FREQ,
                     val_steps=DP_VAL_STEPS, cli_extra=(), kernels=False,
                     tag="[14] (a)"):
    """Drive (a): ``nproc`` ranks on ``device`` (``cuda`` alone: one card a
    rank) over ``backend``. First the data-parallel step's step 1 against
    one process on the global batch from the same weights, both in f32
    with cuDNN's TF32 off: losses and grad_norm to rtol 2e-4,
    num_positives exactly, and the parameters: the two updates' relative
    L2 difference at most 3 times (and 1e-5 at least) what one process's
    update moves when it takes the same batch in reverse order (the
    spread of the same sums in another order; the elements beyond rtol
    5e-4 / atol 1e-5 are logged for both). Then the pretrain CLI, with
    TF32 as phase 10 has it: the merged val loss and saved_best equal on
    every rank, the checkpoint written by rank 0 alone, K3 / K4 once a
    step and a val batch and K1 once a val batch on every rank. Returns
    the ranks' results."""
    overrides = overrides or {}
    on_card = torch.device(device).type == "cuda"
    out = f"{tmp}/dp_pretrain_{nproc}_{backend}"
    cli = ["--num-classes", str(classes), "--batch-size", str(batch),
           "--steps", str(steps), "--val-freq", str(val_freq),
           "--val-steps", str(val_steps), "--log-freq", str(val_freq),
           "--eval-map", "--workers", "4", "--mesh", str(nproc),
           "--device", device, "--dist-backend", backend,
           "--checkpoint-dir", f"{out}/ck", "--per-cat-dir", f"{out}/pc",
           "--log-file", f"{out}/metrics.jsonl"] + list(cli_extra)
    ranks = torchrun(nproc, dict(
        drive="pretrain", out=out, device=device, backend=backend, img=img,
        classes=classes, batch=batch, overrides=overrides, cli=cli,
        window=DP_PROFILE_STEPS, kernels=kernels, card=CARD), tag)

    # the same step in this process on the global batch, and again on the
    # batch in reverse order
    runs, before, _ = one_process_steps(
        "cuda:0" if on_card else device, img, classes, overrides,
        batch * nproc, "backbone")
    want, bound = hold_step1(tag, out, ranks, runs, before, on_card)
    rel = {k: abs(ranks[0]["step1"][k] - want[k]) / abs(want[k])
           for k in ("loss", "class_loss", "box_loss", "grad_norm")}
    log(f"{tag} step 1 of {nproc} ranks x {batch} vs one process x "
        f"{batch * nproc}: relative differences {rel}, num_positives "
        f"{want['num_positives']:.0f} equal, the update within {bound:.3g} "
        f"relative L2; {ranks[0]['step1_collectives']} collectives a step")
    for r, res in enumerate(ranks):
        if kernels:
            check(res.get("kernel_cases") == "passed",
                  f"{tag} rank {r}: phase 3's kernel cases did not run")
            log(f"{tag} rank {r} on {res['device']}: phase 3's K1-K4 cases "
                "against their plain versions passed on this card")
        log(f"{tag} [{CARD}] rank {r} ({res['device']}, {backend}): "
            f"{res['step_ms']:.3f} ms a step at {batch} a rank, "
            f"{batch * nproc * 1e3 / res['step_ms']:.2f} images/s; "
            f"collectives a step {res['window']}")

    logs = [res["cli_logs"] for res in ranks]

    def rows(log_, key):
        return [(e["step"], e[key]) for e in log_ if key in e]
    val, best = [rows(x, "val_loss") for x in logs], \
        [rows(x, "saved_best") for x in logs]
    check(val[0] and all(v == val[0] for v in val),
          f"{tag} merged val losses differ between ranks: {val}")
    check(best[0] and all(b == best[0] for b in best),
          f"{tag} saved_best decisions differ between ranks: {best}")
    check([e["step"] for e in logs[0] if "val_mAP" in e]
          == list(range(val_freq, steps + 1, val_freq)),
          f"{tag} val_mAP not logged at each validation")
    check(ranks[0]["ckpt_writes"] and not any(res["ckpt_writes"]
                                              for res in ranks[1:]),
          f"{tag} checkpoint writes by rank: "
          f"{[res['ckpt_writes'] for res in ranks]}")
    check(not [f for f in os.listdir(f"{out}/ck") if ".tmp" in f]
          and CheckpointManager(f"{out}/ck").latest_step() == steps,
          f"{tag} checkpoint directory {os.listdir(f'{out}/ck')}")
    val_batches = (steps // val_freq) * -(-val_steps // nproc)
    if on_card:
        want_l = {"K1": val_batches, "K2": 0, "K3": steps + val_batches,
                  "K4": steps + val_batches}
        for r, res in enumerate(ranks):
            check(res["cli_launches"] == want_l,
                  f"{tag} rank {r} CLI launches {res['cli_launches']}, not "
                  f"{want_l}")
    rates = [[e["img_per_sec"] for e in x if "img_per_sec" in e]
             for x in logs]
    log(f"{tag} pretrain CLI: {steps} steps, val losses {val[0]}, "
        f"saved_best {best[0]} on every rank; checkpoint files written by "
        f"rank 0 only ({ranks[0]['ckpt_writes']}); launches by rank "
        f"{[res['cli_launches'] for res in ranks]}; img_per_sec a rank by "
        f"log step {rates}")
    return ranks


def dp_nccl_path(tmp, device="cuda", tag="[14] (b)"):
    """Drive (b): the data-parallel step as one rank over NCCL, timed with
    its collective window (drive (a)'s step, at DP_BATCH), then the
    pretrain CLI as that rank (``--mesh 1`` under torchrun), 3 steps: the
    data-parallel path runs on the card."""
    out = f"{tmp}/dp_nccl"
    ranks = torchrun(1, dict(
        drive="pretrain", out=out, device=device, backend="nccl", img=IMG,
        classes=NUM_CLASSES, batch=DP_BATCH, overrides={},
        window=DP_PROFILE_STEPS, card=CARD, cli=[
            "--num-classes", str(NUM_CLASSES), "--batch-size",
            str(DP_BATCH), "--steps", "3", "--val-freq", "100",
            "--log-freq", "3", "--workers", "4", "--mesh", "1",
            "--device", device, "--checkpoint-dir", f"{out}/ck",
            "--per-cat-dir", f"{out}/pc"]), tag)
    res = ranks[0]
    check(res["cli_collectives"] >= 3 * 3,
          f"{tag} the data-parallel step ran {res['cli_collectives']} "
          "collectives in 3 steps")
    check(res["cli_launches"]["K3"] == res["cli_launches"]["K4"] == 3,
          f"{tag} launches {res['cli_launches']}")
    check(any("loss" in e for e in res["cli_logs"]), f"{tag} no loss logged")
    log(f"{tag} [{CARD}] the pretrain CLI as one rank over nccl: 3 steps at "
        f"{DP_BATCH}, {res['cli_collectives']} collectives, launches "
        f"{res['cli_launches']}, logs {res['cli_logs']}")
    log(f"{tag} [{CARD}] the data-parallel step as one rank over nccl "
        f"(D0@512 f32, TF32 on, {DP_BATCH} images): {res['step_ms']:.3f} ms "
        f"a step, {DP_BATCH * 1e3 / res['step_ms']:.2f} images/s; "
        f"collectives a step {res['window']}")
    return res


def dp_validate_path(tmp, device="cuda:0", backend="gloo", nproc=2,
                     img=IMG, batch=VAL_BATCH, n_images=VAL_IMAGES,
                     one=None, tag="[14] (c)"):
    """Drive (c): ``validate --mesh N`` over phase 9's fixture (bf16,
    energy OOD) against one process (``one``: phase 9's metrics on the
    same fixture and weights, else run here): the same images and metrics
    (AP to 1e-3: the last batch runs at another size on rank 0), the
    ground truth at AP 1.0 through the merged evaluators, K2 and K1 once
    a non-empty batch on every rank."""
    on_card = torch.device(device).type == "cuda"
    out = f"{tmp}/dp_validate_{nproc}_{backend}"
    root, pth = f"{tmp}/coco", f"{tmp}/d0.pth"
    if not os.path.exists(root):
        write_coco_fixture(root, n=n_images)
        write_reference_pth(pth)
    common = ["--dataset", "coco2017", "--data", root, "--checkpoint", pth,
              "--batch-size", str(batch), "--ood-method", "energy",
              "--compute-dtype", "bfloat16", "--image-size", str(img),
              "--workers", "2"]
    ranks = torchrun(nproc, dict(
        drive="validate", out=out, device=device, backend=backend, img=img,
        argv=common + ["--mesh", str(nproc), "--device", device,
                       "--dist-backend", backend], card=CARD), tag)
    if one is None:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            one = validate.main(common + ["--device",
                                          "cuda:0" if on_card else device])
        sync_if(on_card)
    for r, res in enumerate(ranks):
        m = res["metrics"]
        check(m["images"] == one["images"] == n_images,
              f"{tag} rank {r} evaluated {m['images']} of {n_images}")
        diff = {k: abs(m[k] - one[k]) for k in one
                if k not in ("img_per_sec",) and k in m}
        check(set(m) == set(one) and all(v <= 1e-3 for v in diff.values()),
              f"{tag} rank {r} metrics {m} vs one process {one}")
        check(all(abs(v - 1.0) < 1e-12 for v in res["oracle"].values()),
              f"{tag} rank {r} oracle {res['oracle']}")
        batches = sum(1 for n in res["rows"] if n)
        if on_card:
            check(res["launches"] == {"K1": batches, "K2": batches},
                  f"{tag} rank {r}: K1 / K2 must launch once a batch "
                  f"({batches}): {res['launches']}")
        log(f"{tag} rank {r}: rows a batch {res['rows']}, launches "
            f"{res['launches']}, metrics {m}; largest difference from one "
            f"process {max(diff.values()):.3g}; ground truth as detections "
            f"{res['oracle']}")
    log(f"{tag} one process: {one}")
    return ranks, one


def dp_meta_path(tmp, device="cuda:0", backend="gloo", nproc=2,
                 driver_extra=(), overrides=None, meta_kw=None,
                 tag="[14] (d)"):
    """Drive (d): the meta driver with --episode-mesh N at its defaults
    for 2 phase-B meta updates (meta batch 4, 4 / N episodes a rank an
    update): the logged meta-batch means and final meta parameters equal
    on every rank, K3 / K4 once an episode built; and one update of
    ``make_sharded_meta_step`` on a meta batch of phase-8 episodes
    against ``train_episode``'s sequential accumulation on this process
    (nesterov, as the CPU tests: adam's first step turns rounding into
    +-lr), meta parameters to rtol 1e-5. ``meta_kw`` / ``overrides``
    shrink the sharded step's MetaConfig / model (the CPU rehearsal)."""
    overrides, meta_kw = overrides or {}, meta_kw or {}
    on_card = torch.device(device).type == "cuda"
    out = f"{tmp}/dp_meta_{nproc}_{backend}"
    meta_cfg = MetaConfig(optim="nesterov", **meta_kw)
    iters = 2 * MetaConfig().meta_batch_size // nproc
    ranks = torchrun(nproc, dict(
        drive="meta", out=out, device=device, backend=backend,
        overrides=overrides, meta_kw=meta_kw, card=CARD,
        driver=list(driver_extra) + [
            "--proj-iters", "0", "--total-iters", str(iters),
            "--val-freq", "100", "--log-freq", str(iters // 2),
            "--episode-mesh", str(nproc), "--device", device,
            "--dist-backend", backend, "--checkpoint-dir", f"{out}/ck",
            "--per-cat-dir", f"{out}/pc"]), tag)
    logs = [[{k: v for k, v in e.items() if k != "eps_per_sec"}
             for e in res["driver_logs"]] for res in ranks]
    check(all(x == logs[0] for x in logs) and logs[0][-1]["final_iter"]
          == iters, f"{tag} the ranks' logs differ: {logs}")
    metas = [torch.load(f"{out}/driver_meta{r}.pt") for r in range(nproc)]
    check(all(torch.equal(m[t][n], v) for m in metas[1:]
              for t, d in metas[0].items() for n, v in d.items()),
          f"{tag} the ranks' meta parameters differ after the driver")
    for r, res in enumerate(ranks):
        if on_card:
            la = res["driver_launches"]
            check(la["K3"] == la["K4"] == res["builds"] > 0 and la["K2"] == 0,
                  f"{tag} rank {r}: K3 / K4 once a build ({res['builds']}): "
                  f"{la}")
    log(f"{tag} meta driver --episode-mesh {nproc}: {iters} phase-B "
        f"iterations a rank (2 meta updates), logs equal on every rank "
        f"{logs[0]}, builds {[res['builds'] for res in ranks]}, launches "
        f"{[res['driver_launches'] for res in ranks]}; the final meta "
        "parameters equal on every rank")

    one_device = "cuda:0" if on_card else device
    trainer, builder, colors = meta_setup(
        torch.Generator(device=one_device).manual_seed(0), device=one_device,
        meta_cfg=meta_cfg, **overrides)
    before = _cpu(trainer.meta_params)
    episodes = meta_dp_episodes(trainer, builder, colors, one_device,
                                meta_cfg.meta_batch_size)
    with torch.enable_grad():
        seq = [trainer.train_episode(b, phase_a=False) for b in episodes]
    sync_if(on_card)
    check(seq[-1].get("meta_step"), f"{tag} no sequential meta step")
    want = _cpu(trainer.meta_params)
    worst = 0.0
    update = max(float((w - before[t][n]).abs().max())
                 for t, d in want.items() for n, w in d.items())
    for r in range(nproc):
        got = torch.load(f"{out}/sharded_meta{r}.pt")
        for t, d in want.items():
            for n, w in d.items():
                g = got[t][n]
                excess = float(((g - w).abs() - 1e-5 * w.abs()).max())
                check(excess <= 1e-8, f"{tag} rank {r} {t} {n} beyond rtol "
                      f"1e-5 of the sequential step by {excess:.3g}")
                worst = max(worst, float((g - w).abs().max()))
        for k, v in ranks[r]["sharded_metrics"].items():
            m = float(np.mean([float(s[k]) for s in seq]))
            check(abs(v - m) <= 1e-5 * abs(m) + 1e-7,
                  f"{tag} rank {r} metric {k} {v} vs sequential {m}")
    log(f"{tag} make_sharded_meta_step over {nproc} ranks x "
        f"{meta_cfg.meta_batch_size // nproc} episodes equals train_episode's "
        f"sequential accumulation of {meta_cfg.meta_batch_size}: meta "
        f"parameters within rtol 1e-5, the largest difference {worst:.3g} "
        f"against the largest update {update:.3g}")
    return ranks


def data_parallel(tmp, validate_metrics=None):
    """Phase 14 on one card: two ranks on cuda:0 over gloo for (a), (c)
    (against ``validate_metrics``, phase 9's, when given) and (d), one
    rank over NCCL for (b); then (e) where the machine has two cards or
    more."""
    t0 = time.time()
    dp_pretrain_path(tmp)
    dp_nccl_path(tmp)
    dp_validate_path(tmp, one=validate_metrics)
    dp_meta_path(tmp)
    log(f"[14] (a)-(d) took {time.time() - t0:.1f} s")
    cards = torch.cuda.device_count()
    if cards < 2:
        log(f"[14] (e) skipped: this machine has a single card ({CARD})")
        return
    data_parallel_cards(tmp, cards)


def data_parallel_cards(tmp, cards):
    """Phase 14 (e): (a) with phase 3's kernel cases on every rank's own
    card, (c) and (d) over NCCL with one rank a card; then the train step's
    images/s at DP_RATE_BATCH a card with 1, 2, ... ``cards`` ranks and
    its collectives."""
    t0 = time.time()
    dp_pretrain_path(tmp, device="cuda", backend="nccl", nproc=cards,
                     kernels=True, tag="[14] (e)")
    dp_validate_path(tmp, device="cuda", backend="nccl", nproc=cards,
                     tag="[14] (e)")
    dp_meta_path(tmp, device="cuda", backend="nccl", nproc=cards,
                 tag="[14] (e)")
    worlds = sorted({1, 2, cards})
    for world in worlds:
        ranks = torchrun(world, dict(
            drive="rate", out=f"{tmp}/dp_rate_{world}", device="cuda",
            backend="nccl", img=IMG, classes=NUM_CLASSES,
            batch=DP_RATE_BATCH, overrides={}, window=DP_RATE_STEPS,
            card=CARD), "[14] (e)")
        slowest = max(res["step_ms"] for res in ranks)
        log(f"[14] (e) [{CARD}] train step D0@512 f32 x {DP_RATE_BATCH} a "
            f"card, {world} rank(s) over nccl: {slowest:.3f} ms a step "
            f"(slowest rank), {world * DP_RATE_BATCH * 1e3 / slowest:.2f} "
            f"images/s; rank 0 collectives a step {ranks[0]['window']}; "
            f"peak {max(r['peak_gib'] for r in ranks):.2f} GiB")
    log(f"[14] (e) took {time.time() - t0:.1f} s")


# ---------------------------------------------------------------------------
# 16. the spatial leg: the images' rows split over a 2-D mesh's ranks

def spatial_path(tmp, device="cuda:0", backend="gloo", mesh=(1, 2),
                 img=IMG, classes=NUM_CLASSES, batch=SPATIAL_BATCH,
                 overrides=None, steps=SPATIAL_STEPS, tag="[16]"):
    """Phase 16's equality drive: ``rank_spatial`` on a ``mesh`` launch
    (two gloo ranks sharing cuda:0 by default; ``device`` 'cuda' is one
    card a rank) at D0@``img``, f32 with TF32 off, a global batch of
    ``batch``; step 1 held against one process on the same batch to phase
    14 (a)'s bars (``hold_step1``), K3 / K4 once a step on each rank, the
    exchanges of a step logged with their host ms (the profiled step's
    ``odt.spatial.*`` spans), and on the card each rank's step peak memory
    below one process's on the global batch. Returns the ranks'
    results."""
    overrides = overrides or {}
    on_card = torch.device(device).type == "cuda"
    nproc = mesh[0] * mesh[1]
    out = f"{tmp}/spatial_{mesh[0]}x{mesh[1]}_{backend}"
    ranks = torchrun(nproc, dict(
        drive="spatial", out=out, device=device, backend=backend,
        mesh=list(mesh), model="efficientdet_d0", img=img, classes=classes,
        batch=batch, overrides=overrides, steps=steps, card=CARD), tag)
    runs, before, one_peak = one_process_steps(
        "cuda:0" if on_card else device, img, classes, overrides, batch,
        "none")
    want, bound = hold_step1(tag, out, ranks, runs, before, on_card)
    for r, res in enumerate(ranks):
        check(res["shape"] == {"data": mesh[0], "spatial": mesh[1]},
              f"{tag} rank {r} mesh {res['shape']}")
        check(all(math.isfinite(v) for v in res["last"].values()),
              f"{tag} rank {r} metrics after {steps} more steps "
              f"{res['last']}")
        if on_card:
            check(res["launches"]["K3"] == res["launches"]["K4"] == steps,
                  f"{tag} rank {r}: K3 / K4 must launch once a step "
                  f"({steps}): {res['launches']}")
            check(res["step_peak_gib"] < one_peak,
                  f"{tag} rank {r}: the step's peak {res['step_peak_gib']:.3f}"
                  f" GiB is not below one process's {one_peak:.3f} GiB")
    rel = {k: abs(ranks[0]["step1"][k] - want[k]) / abs(want[k])
           for k in ("loss", "class_loss", "box_loss", "grad_norm")}
    slowest = max(res["step_ms"] for res in ranks)
    log(f"{tag} step 1 of the {mesh} mesh ({backend}) x {batch} vs one "
        f"process: relative differences {rel}, num_positives "
        f"{want['num_positives']:.0f} equal, the update within {bound:.3g} "
        f"relative L2; exchanges in step 1 {ranks[0]['step1_exchanges']}, "
        f"{ranks[0]['step1_collectives']} all_reduce_sum collectives")
    for r, res in enumerate(ranks):
        ratio = res.get("step_peak_gib", 0.0) / one_peak if one_peak else 0.0
        log(f"{tag} [{CARD}] rank {r} ({res['device']}, {backend}): "
            f"{res['step_ms']:.3f} ms a step, launches {res['launches']}; "
            f"exchanges a step {res['exchanges']}; a profiled step's "
            f"collectives and exchanges with their host ms "
            f"{res['window']}; the step's peak "
            f"{res.get('step_peak_gib', 0.0):.3f} GiB above its start "
            f"(one process {one_peak:.3f}, ratio {ratio:.3f}), peak "
            f"{res.get('peak_gib', 0.0):.3f} GiB")
    log(f"{tag} [{CARD}] spatial step D0@{img} f32 (TF32 off) x {batch}, "
        f"mesh {mesh} over {backend}: {slowest:.3f} ms a step (slowest "
        f"rank), {batch * 1e3 / slowest:.2f} images/s")
    return ranks


def spatial_d7x(tmp, cards, tag="[16] (cards)"):
    """The case the leg exists for: one step of ``tf_efficientdet_d7x`` at
    its 1536 px, 90 classes, f32, one image a data block, on a (1,
    ``cards``) mesh over NCCL, one card a rank: finite losses, K3 / K4
    once on each rank, each card's peak memory."""
    ranks = torchrun(cards, dict(
        drive="spatial", out=f"{tmp}/spatial_d7x", device="cuda",
        backend="nccl", mesh=[1, cards], model="tf_efficientdet_d7x",
        img=D7X_IMG, classes=NUM_CLASSES, batch=1, overrides={}, steps=1,
        save=False, card=CARD), tag, timeout=900)
    for r, res in enumerate(ranks):
        check(all(math.isfinite(v) for v in res["step1"].values())
              and all(math.isfinite(v) for v in res["last"].values()),
              f"{tag} rank {r} D7x metrics {res['step1']} {res['last']}")
        check(res["step1_launches"]["K3"] == res["step1_launches"]["K4"]
              == 1, f"{tag} rank {r} launches {res['step1_launches']}")
    log(f"{tag} [{CARD}] tf_efficientdet_d7x@{D7X_IMG} f32, 1 image, mesh "
        f"(1, {cards}) over nccl: step 1 {ranks[0]['step1']}; "
        f"{ranks[0]['step_ms']:.3f} ms a step (step 2); exchanges a step "
        f"{ranks[0]['exchanges']}; a profiled step's collectives and "
        f"exchanges with their host ms {ranks[0]['window']}; "
        f"peak GiB by card {[round(r['peak_gib'], 3) for r in ranks]}, the "
        f"step's {[round(r['step_peak_gib'], 3) for r in ranks]}")
    return ranks


def spatial_cards(tmp, cards):
    """Phase 16 across cards (``--cards``, four cards or more): a (2, 2)
    NCCL run of ``spatial_path``, then ``spatial_d7x`` on (1, 4); with
    fewer cards it logs that and returns."""
    if cards < 4:
        log(f"[16] (cards) skipped: this machine has {cards} card(s)")
        return
    t0 = time.time()
    spatial_path(tmp, device="cuda", backend="nccl", mesh=(2, 2),
                 tag="[16] (cards)")
    spatial_d7x(tmp, 4)
    log(f"[16] (cards) took {time.time() - t0:.1f} s")


# ---------------------------------------------------------------------------
# 15. the examples: open_set_demo and selection_quality at their defaults

class TimedLines(io.TextIOBase):
    """A text sink that keeps each printed line with the seconds from the
    sink's creation to the write that ended the line."""

    def __init__(self):
        super().__init__()
        self.t0 = time.perf_counter()
        self.lines = []
        self._part = ""

    def write(self, s):
        now = time.perf_counter() - self.t0
        *done, self._part = (self._part + s).split("\n")
        self.lines += [(now, line) for line in done]
        return len(s)


def run_timed(main_fn, argv):
    """``main_fn(argv)`` with its printed lines captured. Returns (what
    main returned, [(seconds, line)] of its printed lines, the wall
    seconds of the call)."""
    out = TimedLines()
    with contextlib.redirect_stdout(out):
        result = main_fn(argv)
    return result, out.lines, time.perf_counter() - out.t0


def stage_seconds(timed, wall, marks):
    """Wall seconds of consecutive stages of a timed run: ``marks`` is an
    ordered list of (stage, predicate); a stage ends at the first JSON
    line after the previous stage's end that its predicate accepts, the
    last stage at the end of the run. A stage whose line never comes is
    merged into the next one (its seconds are None)."""
    out, start, pos = {}, 0.0, 0
    for name, ends in marks:
        hit = next((i for i in range(pos, len(timed)) if ends(timed[i][1])),
                   None)
        if hit is None:
            out[name] = None
            continue
        out[name] = round(timed[hit][0] - start, 3)
        start, pos = timed[hit][0], hit + 1
    out["rest"] = round(wall - start, 3)
    return out


def _finite(x):
    return isinstance(x, (int, float)) and math.isfinite(x)


EXAMPLES = {"open_set_demo": open_set_demo,
            "selection_quality": selection_quality}


def example_main(spec):
    """One example of phase 15 in its own process (``chip_smoke.py
    --example <spec>``, started by ``examples_path``): its ``main`` on
    ``spec['argv']`` with the printed lines timed, the kernels' launch
    counts from 0, with the starting process's CPU threads and torch's
    deterministic algorithms (``run_examples`` sets the cuBLAS workspace
    they need); the result in ``{out}/{name}.result.json``."""
    spec = json.loads(spec)
    torch.set_num_threads(spec["threads"])
    torch.backends.cudnn.allow_tf32 = True         # as phases 10-14
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True)
    reset_launches()
    with torch.enable_grad():
        result, lines, wall = run_timed(EXAMPLES[spec["name"]].main,
                                        spec["argv"])
    with open(os.path.join(spec["out"], f"{spec['name']}.result.json"),
              "w") as f:
        json.dump({"result": result, "lines": lines, "wall": wall,
                   "launches": launch_counts()}, f)
    return 0


def start_examples(tmp, argvs):
    """Every example of ``argvs`` ({name: argv}) started at once, each in
    its own process (``example_main``). Returns {name: its process}."""
    procs = {}
    # deterministic cuBLAS calls need a fixed workspace, set before the
    # process's first one
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    try:
        for name, argv in argvs.items():
            spec = json.dumps(dict(name=name, argv=list(argv), out=tmp,
                                   threads=torch.get_num_threads()))
            with open(os.path.join(tmp, f"{name}.err"), "w") as err:
                procs[name] = subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), "--example",
                     spec], stdout=err, stderr=subprocess.STDOUT, env=env)
    except BaseException:
        stop_examples(procs)
        raise
    return procs


def stop_examples(procs):
    """Kills every process of ``procs`` still running."""
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def run_examples(tmp, argvs, timeout=EXAMPLE_TIMEOUT, procs=None):
    """Every example of ``argvs`` ({name: argv}) at once, each in its own
    process (``start_examples``, unless ``procs`` holds the processes it
    started on these arguments); waits for all, stops any still running on
    a failure. Returns {name: its result file's content}, each printed
    line logged with its time."""
    procs = procs or {}
    try:
        procs = procs or start_examples(tmp, argvs)
        deadline = time.time() + timeout
        for name, proc in procs.items():
            code = proc.wait(timeout=max(deadline - time.time(), 1.0))
            if code:
                for line in open(os.path.join(tmp, f"{name}.err")
                                 ).read().splitlines()[-30:]:
                    log(f"[15] {name}: {line}")
                check(False, f"[15] {name} exited {code}")
    finally:
        stop_examples(procs)
    out = {}
    for name in argvs:
        with open(os.path.join(tmp, f"{name}.result.json")) as f:
            out[name] = json.load(f)
        for at, line in out[name]["lines"]:
            log(f"[15] {name} +{at:.1f} s {line}")
        out[name]["timed"] = [(at, obj) for at, line in out[name]["lines"]
                              for obj in json_lines(line)]
    return out


def example_kernel_inputs(device="cuda"):
    """The kernels' inputs at the examples' call sites, at
    selection_quality's defaults (D0 at 256 px, 6 classes, batch 16,
    f32): the anchors, the padded ground truth of the first val batch (K3
    -> K4 of a train step take such a batch), and the seeded model's
    ``exact`` candidates on its images, three class biases raised by 2 so
    that the NMS has work (K1). Returns (anchors, anchor boxes, boxes,
    classes, candidates)."""
    args = selection_quality.build_argparser().parse_args([])
    size = (args.image_size, args.image_size)
    cfg = get_efficientdet_config(
        "efficientdet_d0", num_classes=args.num_classes).replace(
        image_size=size)
    model = create_model_from_config(cfg, seed=0, device=device)
    val = SyntheticDetectionDataset(num_images=args.batch_size,
                                    image_size=size,
                                    num_classes=args.num_classes, seed=101)
    batch = collate_batch([val[i] for i in range(args.batch_size)])
    anchors = Anchors.from_config(cfg)
    with torch.no_grad():
        model.class_net.predict_bias().view(9, cfg.num_classes)[:, :3] += 2.0
        cls, box = model(normalize_uint8(
            torch.from_numpy(batch["image"]).to(device)))
        cand = pp.select_candidates(cls, box, anchors, cfg.num_classes,
                                    cfg.max_detection_points,
                                    topk_method="exact")
    return (anchors, torch.from_numpy(anchors.boxes).to(device),
            torch.from_numpy(batch["bbox"]).to(device),
            torch.from_numpy(batch["cls"]).to(device), cand)


def example_kernels():
    """Phase 15's kernels on the card at the examples' call sites
    (``example_kernel_inputs``): K3 -> K4 against their plain versions
    (label_compare) and K1 (hard NMS at 0.3, 100 an image, as
    ``generate_detections``) keeping the plain version's indices, then
    each timed beside its bound and plain version."""
    anchors, anchor_boxes, boxes, cls, cand = example_kernel_inputs()
    _, err_box, codes, _ = label_compare(anchor_boxes, boxes, cls,
                                         unmatched=0.5)
    dets_k, keep_k = pp.batch_detection(*cand[:4], kernels=True)
    dets_p, keep_p = pp.batch_detection(*cand[:4], kernels=False)
    sync()
    check(torch.equal(keep_k, keep_p), "[15] K1 keep indices differ")
    check(torch.allclose(dets_k, dets_p, rtol=1e-4, atol=1e-4),
          "[15] K1 and plain detections differ")
    log(f"[15] examples' shapes: K3 / K4 [{boxes.shape[0]}, "
        f"{boxes.shape[1]}] x {anchor_boxes.shape[0]} anchors equal to "
        f"plain ({int((codes >= 0).sum())} positives, box max abs err "
        f"{err_box:.3g}); K1 [{keep_k.shape[0]}, {cand[0].shape[1]}] keep "
        f"equal ({int((keep_k >= 0).sum())} kept)")
    t = label_kernel_times(anchor_boxes, boxes, cls, tag=f"[15] [{CARD}]")
    t["K1"] = nms_times(cand, 100, 0.3, "[15]")
    return t


def examples_argvs(tmp, device="cuda", open_args=(), select_args=()):
    """{example: argv} of phase 15: ``open_args`` / ``select_args`` on
    the device, selection_quality's ``--out`` in ``tmp``."""
    dev = [] if device == "cuda" else ["--device", device]
    path = os.path.join(tmp, "selection_quality_out.json")
    return {"open_set_demo": list(open_args) + dev,
            "selection_quality": ["--out", path] + list(select_args) + dev}


def examples_path(tmp, device="cuda", open_args=(), select_args=(),
                  min_overlap=EXAMPLE_MIN_OVERLAP,
                  min_pascal=EXAMPLE_MIN_PASCAL, started=None):
    """Phase 15: ``examples.open_set_demo.main`` and
    ``examples.selection_quality.main --out`` at their defaults (or with
    ``open_args`` / ``select_args``), the two at once in two processes
    (``run_examples``; ``started`` holds them where ``start_examples``
    started them on ``examples_argvs``' arguments earlier, as ``main``
    does beside phase 14), each result line printed with the wall seconds of
    each stage and the kernels' launches. Fails on a non-finite AUROC,
    FPR95 or mAP, on ``approx``'s overlap with ``exact`` below
    ``min_overlap``, on ``exact``'s PASCAL mAP@0.5 below ``min_pascal``,
    on a result file that differs from the printed line, and on the card
    unless K3 and K4 launched once a train step and K1 once a predict call
    (K2 is logged: in f32 no selection takes its packed route). Returns
    {example: (result, stages, launches)}."""
    on_card = torch.device(device).type == "cuda"
    path = os.path.join(tmp, "selection_quality_out.json")
    argvs = examples_argvs(tmp, device, open_args, select_args)
    runs = run_examples(tmp, argvs, procs=started)
    out = {}

    run = runs["open_set_demo"]
    result, launches, wall = run["result"], run["launches"], run["wall"]
    steps = open_set_demo.build_argparser().parse_args(
        argvs["open_set_demo"]).steps
    stages = stage_seconds(run["timed"], wall, [
        ("build", lambda o: o.get("phase") == "train"),
        ("train", lambda o: o.get("step") == steps),
        ("evaluate", lambda o: "auroc_gt_regions" in o)])
    for key in ("auroc_gt_regions", "fpr95_gt_regions"):
        check(_finite(result[key]), f"[15] open_set_demo {key}: "
              f"{result[key]!r}")
    if result["auroc_detections"] is None:
        check("note" in result, "[15] open_set_demo: no detection AUROC "
              "and no note")
    else:
        check(_finite(result["auroc_detections"])
              and _finite(result["fpr95_detections"]),
              f"[15] open_set_demo detection AUROC / FPR95: {result}")
    if on_card:
        check(launches["K3"] == launches["K4"] == steps,
              f"[15] open_set_demo: K3 / K4 must launch once a train step "
              f"({steps}): {launches}")
        check(launches["K1"] == 2, f"[15] open_set_demo: K1 must launch "
              f"once a predict call (2): {launches}")
    beside = " and phase 14" if started else ""
    log(f"[15] [{CARD}] open_set_demo (beside selection_quality{beside}): "
        f"{wall:.1f} s, stages (s) {stages}, train "
        f"{1e3 * (stages['train'] or 0) / steps:.1f} ms a step; launches "
        f"{launches}")
    out["open_set_demo"] = (result, stages, launches)

    run = runs["selection_quality"]
    result, launches, wall = run["result"], run["launches"], run["wall"]
    args = selection_quality.build_argparser().parse_args(
        argvs["selection_quality"])
    steps, val_batches = args.steps, args.val_images // args.batch_size
    with open(path) as f:
        written = json_lines(f.read())
    check(len(written) == 1 and written[0]["selection_quality"] == result,
          "[15] selection_quality: the --out file differs from the result")
    stages = stage_seconds(run["timed"], wall, [
        ("build", lambda o: o.get("phase") == "train"),
        ("train", lambda o: o.get("phase") == "train_done"),
        ("forward", lambda o: o.get("phase") == "forward_done"),
        ("exact", lambda o: o.get("method") == "approx"),
        ("approx", lambda o: o.get("method") == "per_anchor"),
        ("per_anchor", lambda o: "selection_quality" in o)])
    for method, metrics in result.items():
        for key in ("pascal_map50", "coco_map", "coco_map50"):
            check(_finite(metrics[key]), f"[15] selection_quality {method} "
                  f"{key}: {metrics[key]!r}")
    check(result["approx"]["overlap_vs_exact"] >= min_overlap,
          f"[15] selection_quality: approx's overlap with exact "
          f"{result['approx']['overlap_vs_exact']} < {min_overlap}")
    check(result["exact"]["pascal_map50"] >= min_pascal,
          f"[15] selection_quality: exact's PASCAL mAP@0.5 "
          f"{result['exact']['pascal_map50']} < {min_pascal}")
    if on_card:
        check(launches["K3"] == launches["K4"] == steps,
              f"[15] selection_quality: K3 / K4 must launch once a train "
              f"step ({steps}): {launches}")
        check(launches["K1"] == len(result) * val_batches,
              f"[15] selection_quality: K1 must launch once a method and "
              f"val batch ({len(result)} x {val_batches}): {launches}")
    log(f"[15] [{CARD}] selection_quality (beside open_set_demo{beside}): "
        f"{wall:.1f} s, stages (s) {stages}, train "
        f"{1e3 * (stages['train'] or 0) / steps:.1f} ms a step; launches "
        f"{launches}")
    out["selection_quality"] = (result, stages, launches)
    return out



# ---------------------------------------------------------------------------
# 17. the benchmark entry point (run_bench) and the roofline tools

@contextlib.contextmanager
def bench_env(**values):
    """The BENCH_* environment set to ``values`` (and nothing else) inside
    the block."""
    saved = {k: v for k, v in os.environ.items() if k.startswith("BENCH_")}
    for k in saved:
        del os.environ[k]
    os.environ.update({f"BENCH_{k}": str(v) for k, v in values.items()})
    try:
        yield
    finally:
        for k in [k for k in os.environ if k.startswith("BENCH_")]:
            del os.environ[k]
        os.environ.update(saved)


def bench_rows(tag, overrides=None, **env):
    """``run_bench.main()`` in this process under the BENCH_* ``env``, its
    printed rows logged under ``tag``; every timed call counted and the
    kernels' launches read around each row's timing
    (``run_bench.device_time``) and around the whole run. Returns (rows,
    [{calls, launches} a timed row], the run's launches)."""
    real, records = run_bench.device_time, []

    def timed(fn, args, **kw):
        calls = [0]

        def counted(*a):
            calls[0] += 1
            return fn(*a)
        before = launch_counts()
        t = real(counted, args, **kw)
        after = launch_counts()
        records.append({"calls": calls[0], "launches": {
            k: after[k] - before[k] for k in after}})
        return t
    reset_launches()
    run_bench.device_time = timed
    try:
        with bench_env(**env):
            rows, _, printed = run_driver(
                lambda _argv: run_bench.main(**(overrides or {})), [], tag)
    finally:
        run_bench.device_time = real
    check(printed == rows, f"{tag} the printed rows differ from main's")
    return rows, records, launch_counts()


def bench_row_checks(tag, rows, names):
    check([r["metric"] for r in rows] == names,
          f"{tag} rows {[r['metric'] for r in rows]}, not {names}")
    check(run_bench.finite_rows(rows) and all(
        r["vs_baseline"] is None for r in rows),
        f"{tag} a row is not finite and positive, or holds an error: {rows}")


def bench_path(tmp, device="cuda", batch=128, iters=BENCH_ITERS,
               meta_iters=BENCH_META_ITERS, overrides=None, busy=None,
               roofline_args=ROOFLINE_ARGS, meta_size=None,
               cli_env=BENCH_CLI_ENV):
    """Phase 17: (a) ``run_bench.main()`` at its defaults (``batch``,
    ``iters``; the train row, the exact row, the north-star row last),
    each row finite, K3 / K4 once a timed train step, K2 and K1 once a
    call of the exact row (K2's packed keys give the exact selection's
    first stage on bf16 logits) and of the north-star row;
    (b) ``BENCH_MODE=meta`` (bf16, 640 / 256 px, or ``meta_size``;
    ``meta_iters`` timed calls a run: K3 / K4 once at the build, nothing
    in the timed episodes) and
    ``BENCH_MODE=loader`` at ``batch``; (c) the CLI as a subprocess under
    ``cli_env``; (d) with ``busy`` (phase 5's B = 128 request and phase
    7's B = 128 step busy seconds) no row faster than the card's busy
    time allows, BENCH_ROW_MARGIN over; (e) one ``train_roofline`` row
    with a profiler trace, ``profile_kernel_stats`` over it and
    ``run_roofline_sweep --only predict``, every roofline share at most
    1. ``overrides`` go into every model config and ``roofline_args``
    to the roofline (the CPU rehearsal's small models). Returns
    {'rows', 'records', 'meta', 'loader', 'cli', 'roofline', 'sweep'}."""
    on_card = torch.device(device).type == "cuda"
    dev = {} if on_card else {"DEVICE": device}
    out = {}

    # (a) the default run
    t0 = time.time()
    rows, records, launches = bench_rows(
        "[17] (a)", overrides, BATCH=batch, ITERS=iters, **dev)
    size = (overrides or {}).get("image_size", (IMG, IMG))[0]
    stages = "preproc+fwd+softNMS+OOD"
    bench_row_checks("[17] (a)", rows, [
        run_bench.train_metric("efficientdet_d0", size, "bfloat16",
                               "backbone", batch),
        f"efficientdet_d0@{size} e2e inference ({stages}, topk=exact), "
        f"bs={batch}",
        f"efficientdet_d0@{size} e2e inference ({stages}), bs={batch}"])
    check(len(records) == 3, f"[17] (a) {len(records)} timed rows, not 3")
    if on_card:
        # the exact selection's first stage reads K2's packed keys too
        want = [{"K1": 0, "K2": 0, "K3": 1, "K4": 1},
                {"K1": 1, "K2": 1, "K3": 0, "K4": 0},
                {"K1": 1, "K2": 1, "K3": 0, "K4": 0}]
        for rec, per_call, r in zip(records, want, rows):
            expect = {k: v * rec["calls"] for k, v in per_call.items()}
            check(rec["launches"] == expect,
                  f"[17] (a) {r['metric']}: launches {rec['launches']} over "
                  f"{rec['calls']} calls, not {expect}")
    for r, rec in zip(rows, records):
        log(f"[17] (a) [{CARD}] {r['metric']}: {r['value']} {r['unit']} "
            f"({rec['calls']} timed calls, launches {rec['launches']})")
    log(f"[17] (a) launches over the run {launches}; {time.time() - t0:.1f} s")
    out["rows"], out["records"] = rows, records

    # (d) no row faster than the card's busy time
    if busy is not None:
        for r, (what, seconds) in zip((rows[2], rows[0]), (
                ("phase 5 B=128 request", busy["predict"]),
                ("phase 7 B=128 step", busy["train"]))):
            ceiling = BENCH_ROW_MARGIN * batch / seconds
            check(r["value"] <= ceiling,
                  f"[17] (d) {r['metric']}: {r['value']} images/s above "
                  f"{ceiling} ({BENCH_ROW_MARGIN} x {batch} / {what} busy "
                  f"{seconds} s): the timer read the enqueue")
            log(f"[17] (d) [{CARD}] {r['metric']}: {r['value']} images/s <= "
                f"{ceiling} ({BENCH_ROW_MARGIN} x {batch} images / {what} "
                f"busy {seconds * 1e3} ms)")
    if on_card:
        torch.cuda.empty_cache()

    # (b) meta and loader
    t0 = time.time()
    qry, sup = meta_size or (640, 256)
    meta_overrides = {k: v for k, v in (overrides or {}).items()
                      if k != "image_size"}
    rows, records, launches = bench_rows(
        "[17] (b)", meta_overrides, MODE="meta", META_QRY=qry,
        META_SUP=sup, ITERS=meta_iters, **dev)
    mc = MetaConfig(img_size=sup, qry_img_size=qry)
    bench_row_checks("[17] (b)", rows, [run_bench.meta_metric(
        "efficientdet_d0", "bfloat16", mc, sup, qry)])
    if on_card:
        check(launches == {"K1": 0, "K2": 0, "K3": 1, "K4": 1}
              and set(records[0]["launches"].values()) == {0},
              f"[17] (b) meta: K3 / K4 once at the build and nothing in "
              f"the timed episodes: {launches}, {records}")
    log(f"[17] (b) [{CARD}] {rows[0]['metric']}: {rows[0]['value']} "
        f"episodes/s ({records[0]['calls']} timed episodes; launches "
        f"{launches}); {time.time() - t0:.1f} s")
    out["meta"] = rows[0]
    if on_card:
        torch.cuda.empty_cache()
    t0 = time.time()
    rows, _, _ = bench_rows("[17] (b)", None, MODE="loader", BATCH=batch,
                            ITERS=BENCH_LOADER_ITERS, **dev)
    bench_row_checks("[17] (b)", rows, [run_bench.loader_metric(
        native_decode_available(), batch)])
    log(f"[17] (b) [{CARD}] {rows[0]['metric']}: {rows[0]['value']} "
        f"images/s over {BENCH_LOADER_ITERS} batches; "
        f"{time.time() - t0:.1f} s")
    out["loader"] = rows[0]

    # (c) the CLI itself
    t0 = time.time()
    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    env.update({f"BENCH_{k}": str(v) for k, v in {**cli_env, **dev}.items()})
    proc = subprocess.run(
        [sys.executable, "-m", "ood_object_detection_tpu_torch.run_bench"],
        capture_output=True, text=True, timeout=600, env=env,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    for line in (proc.stdout + proc.stderr).strip().splitlines()[-20:]:
        log(f"[17] (c) {line}")
    check(proc.returncode == 0, f"[17] (c) the CLI exited {proc.returncode}")
    rows = json_lines(proc.stdout)
    bench_row_checks("[17] (c)", rows, [
        f"efficientdet_d0@{IMG} e2e inference ({stages}), "
        f"bs={cli_env['BATCH']}"])
    log(f"[17] (c) [{CARD}] the CLI ({cli_env}): {rows[0]['value']} "
        f"images/s; {time.time() - t0:.1f} s")
    out["cli"] = rows[0]

    # (e) rooflines
    t0 = time.time()
    prof = os.path.join(tmp, "roofline_trace")
    argv = list(roofline_args) + ["--profile-dir", prof] + (
        [] if on_card else ["--device", device])
    roof, _, _ = run_driver(train_roofline.main, argv, "[17] (e)")
    out["roofline"] = roof
    shares = [roof["hbm_bw_utilization"], roof["tensor_core_utilization"]]
    if on_card:
        table, _, _ = run_driver(profile_kernel_stats.main,
                                 [prof, "--calls", "3", "--top", "15"],
                                 "[17] (e) kernels")
        check(table["rows"], "[17] (e) the trace holds no device kernel")
        log(f"[17] (e) [{CARD}] traced step: device "
            f"{table['device_us_per_call'] / 1e3} ms, busy "
            f"{table['busy_us_per_call'] / 1e3} ms, span "
            f"{table['span_us_per_call'] / 1e3} ms a step (3 steps)")
    else:
        check(os.path.exists(os.path.join(prof, "trace.json")),
              "[17] (e) no trace written")
    sweep_out = os.path.join(tmp, "roofline_sweep.json")
    sweep, _, _ = run_driver(
        run_roofline_sweep.main, ["--only", "predict", "--out", sweep_out,
                                  "--iters", str(ROOFLINE_ITERS)]
        + ([] if on_card else ["--device", device]), "[17] (e) sweep")
    check(len(sweep) == 1 and sweep[0]["status"] == "ok",
          f"[17] (e) the predict sweep row failed: {sweep}")
    out["sweep"] = sweep[0]
    shares += [sweep[0]["hbm_bw_utilization"],
               sweep[0]["tensor_core_utilization"]]
    check(all(0.0 < x <= 1.0 for x in shares),
          f"[17] (e) a roofline share outside (0, 1]: {shares}")
    for r in (roof, sweep[0]):
        log(f"[17] (e) [{CARD}] roofline {r['model']} {r['task']} "
            f"bs={r['batch']} freeze_bn={r['freeze_bn']}: "
            f"{r['t_measured_ms']} ms, {r['images_per_sec']} images/s; "
            f"{r['flops_per_step']} FLOPs ({r['matmul_flops_per_step']} "
            f"conv / matmul), {r['hbm_bytes_per_step']} eager bytes; "
            f"bounds {r['t_compute_bound_ms']} / {r['t_hbm_bound_ms']} ms, "
            f"shares tensor cores {r['tensor_core_utilization']}, memory "
            f"{r['hbm_bw_utilization']}")
    log(f"[17] (e) {time.time() - t0:.1f} s")
    return out


# ---------------------------------------------------------------------------
# 18. published weights and timm training checkpoints, through the
#     package's top-level names

def predict_request(bench, imgs, hw, img):
    pre = batched_letterbox_normalize(imgs, hw, target_hw=(img, img),
                                      out_dtype="bfloat16")
    return pre, bench(pre["image"], pre)


def pretrained_path(tmp, gen, device="cuda", img=IMG, batch=BATCH,
                    requests=PRETRAINED_REQUESTS, overrides=None):
    """Phase 18: (a) the seeded D0 with three class biases raised
    (write_reference_pth) in a cache directory under the published file
    name of efficientdet_d0, ``OOD_TPU_CHECKPOINT_CACHE`` pointing there
    and ``urllib.request.urlretrieve`` raising; ``odt.create_model(...,
    pretrained=True)`` (bf16, soft-NMS, energy; on the card unless
    ``device`` names another) answers ``requests`` requests of ``batch``
    canvases: nothing fetched, ``load_pretrained``'s report with nothing
    missing or unexpected, K2 once a request and K1 on the card, finite
    outputs with detections, each request's detections and OOD scores
    equal to those of ``checkpoint_path=`` on that file, the plain path
    equal on the last batch (plain_path_compare). (b) timm's training
    checkpoint of that state_dict (an ``argparse.Namespace`` and a float
    metric beside it) with an EMA copy whose raised classes are
    EMA_CLASSES: ``checkpoint_ema=True`` loads the EMA copy and answers a
    request as a bare file of the EMA state_dict does; the deploy CLI's
    ``load_checkpoint`` reads it as "reference". Returns the launches of
    (a)'s requests, the plain_path_compare result and the times."""
    on_card = torch.device(device).type == "cuda"
    t_phase = time.time()
    kw = dict(bench_task="predict", num_classes=NUM_CLASSES, soft_nms=True,
              ood_method="energy", compute_dtype="bfloat16",
              image_size=(img, img), **(overrides or {}),
              **({} if on_card else {"device": device}))
    cache = os.path.join(tmp, "cache")
    os.makedirs(cache)
    pth = os.path.join(cache,
                       os.path.basename(PRETRAINED_URLS["efficientdet_d0"]))
    write_reference_pth(pth)
    fetches = []

    def refuse(url, dst):
        fetches.append(url)
        raise RuntimeError(f"[18] (a) a fetch of {url}: the cache holds it")

    reqs = [canvases(batch, gen, img=img, device=device)
            for _ in range(requests)]
    with mock.patch.dict(os.environ, {"OOD_TPU_CHECKPOINT_CACHE": cache}), \
            mock.patch.object(urllib.request, "urlretrieve", refuse):
        bench = odt.create_model("efficientdet_d0", pretrained=True, **kw)
        report = load_pretrained("efficientdet_d0", bench.model)
    check(not fetches, f"[18] (a) urlretrieve called: {fetches}")
    check(not report["missing"] and not report["unexpected"],
          f"[18] (a) load report: missing {report['missing'][:5]}, "
          f"unexpected {report['unexpected'][:5]}")
    check(next(bench.model.parameters()).device.type
          == torch.device(device).type, "[18] (a) the model is not on "
          f"{device}")
    sync_if(on_card)
    reset_launches()
    outs = [predict_request(bench, imgs, hw, img) for imgs, hw in reqs]
    sync_if(on_card)
    launches = launch_counts()
    if on_card:
        check(launches["K2"] == requests and launches["K1"] > 0,
              f"[18] (a) K2 once a request and K1 must launch: {launches}")
    pre, (dets, ood) = outs[-1]
    check(tuple(dets.shape) == (batch, 100, 6)
          and tuple(ood.shape) == (batch, 100), "[18] (a) output shapes")
    check(all(bool(torch.isfinite(d).all()) and bool(torch.isfinite(o).all())
              for _, (d, o) in outs), "[18] (a) non-finite outputs")
    n_det = int((dets[..., 4] > 0).sum())
    check(n_det > 0, "[18] (a) no detections")
    log(f"[18] (a) pretrained=True from the cache ({len(report['loaded'])} "
        f"tensors, urlretrieve called {len(fetches)} times): {requests} "
        f"requests x {batch} images, launches {launches}, {n_det} "
        "detections in the last")
    ref = odt.create_model("efficientdet_d0", checkpoint_path=pth, **kw)
    for (imgs, hw), (_, (d, o)) in zip(reqs, outs):
        _, (d_ref, o_ref) = predict_request(ref, imgs, hw, img)
        check(torch.equal(d, d_ref) and torch.equal(o, o_ref),
              "[18] (a) pretrained=True and checkpoint_path= answer "
              "differently")
    compared = plain_path_compare(bench, pre, tag="[18] (a)")
    sync_if(on_card)
    request_ms = 1e3 * device_time(
        lambda: predict_request(bench, *reqs[0], img), (), iters=1,
        repeats=3, device=device)
    clock = "CUDA events" if on_card else "the host clock"
    log(f"[18] (a) [{CARD}] equal to checkpoint_path= on {requests} "
        f"requests; a B={batch} request {request_ms} ms ({clock}, median "
        "of 3)")

    # (b) timm's training checkpoint, its EMA copy on other classes
    bias = "class_net.predict.conv_pw.bias"
    state = torch.load(pth, weights_only=True)
    ema = dict(state)
    ema_bias = state[bias].clone().view(-1, NUM_CLASSES)
    ema_bias[:, :3] -= 2.0
    ema_bias[:, EMA_CLASSES] += 2.0
    ema[bias] = ema_bias.view(-1)
    timm = os.path.join(tmp, "model_best.pth")
    torch.save({"epoch": 36, "arch": "efficientdet_d0", "version": 2,
                "metric": 0.4183,
                "args": argparse.Namespace(model="efficientdet_d0",
                                           model_ema=True, lr=0.09),
                "state_dict": state, "state_dict_ema": ema}, timm)
    bare = os.path.join(tmp, "ema.pth")
    torch.save(ema, bare)
    picked = odt.create_model("efficientdet_d0", checkpoint_path=timm,
                              checkpoint_ema=True, **kw)
    check(torch.equal(picked.model.class_net.predict_bias().detach().cpu(),
                      ema[bias]), "[18] (b) checkpoint_ema did not pick the "
          "EMA copy")
    odt.load_pytorch_checkpoint(bare, ref.model, strict=True)
    _, (d_ema, o_ema) = predict_request(picked, *reqs[0], img)
    _, (d_bare, o_bare) = predict_request(ref, *reqs[0], img)
    check(torch.equal(d_ema, d_bare) and torch.equal(o_ema, o_bare),
          "[18] (b) the timm container's EMA weights answer unlike the bare "
          "EMA state_dict")
    n_ema = int((d_ema[..., 4] > 0).sum())
    check(n_ema > 0 and not torch.equal(d_ema, outs[0][1][0]),
          "[18] (b) the EMA weights answer as the state_dict's do")
    kind = deploy_infer.load_checkpoint(bench.model, timm)
    check(kind == "reference", f"[18] (b) deploy_infer read the timm "
          f"checkpoint as {kind!r}")
    check(torch.equal(bench.model.class_net.predict_bias().detach().cpu(),
                      state[bias]), "[18] (b) deploy_infer did not load the "
          "state_dict")
    sync_if(on_card)
    seconds = time.time() - t_phase
    log(f"[18] (b) timm checkpoint (args an argparse.Namespace, metric a "
        f"float): checkpoint_ema=True picked the EMA copy, equal to the bare "
        f"EMA file ({n_ema} detections); deploy_infer read it as {kind!r}")
    log(f"[18] [{CARD}] phase 18 took {seconds} s; a B={batch} request "
        f"{request_ms} ms")
    return launches, compared, {"seconds": seconds, "request_ms": request_ms}

if __name__ == "__main__":
    with torch.no_grad():
        if sys.argv[1:2] == ["--rank"]:
            sys.exit(rank_main(sys.argv[2]))
        if sys.argv[1:2] == ["--example"]:
            sys.exit(example_main(sys.argv[2]))
        sys.exit(main(sys.argv[1:]))
