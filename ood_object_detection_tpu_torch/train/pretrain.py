"""Supervised detector pre-training driver (port of
``ood_object_detection_tpu.train.pretrain``).

Focal + huber training on a detection dataset with interleaved
validation, best-val checkpointing and per-category metric dumps
(reference pretrain.py:68-406): the loader (or the category-balanced
``--stream``) copies batches to the card; each train step labels its
anchors there (K3 -> K4), runs the forward and backward, clips, steps
the optimizer and the EMA; each val batch gives the EMA model's loss
(K3 -> K4 again) and, with ``--eval-map``, its detections (K1, hard NMS)
for the evaluator thread. Checkpoints are the port's torch files
(``train.checkpoint``) with the optimizer state and step: ``--resume``
continues from the latest one.

Run: python -m ood_object_detection_tpu_torch.train.pretrain --help

It runs on the CUDA card, and raises without one, unless ``--device cpu``
is given (the kernels' plain versions). Every flag of the JAX CLI is
accepted. ``--dropout`` (the backbone's stochastic depth), ``--remat``
(the first N backbone stages recomputed in the backward) and
``--remat-fpn-heads`` go into the model config as the JAX CLI puts them.

Data parallelism: one process a card, started by torchrun, e.g.
``python -m torch.distributed.run --nproc-per-node 4 -m
ood_object_detection_tpu_torch.train.pretrain --mesh 4 ...``. ``--mesh``
is the number of processes (-1: all of the launch); ``--batch-size`` is
each process's, as in the JAX multi-host loaders. Each rank reads its
stride of the samples, labels and trains on its rows (the global
BatchNorm moments, positives and summed gradients:
``train_state.mesh_train_step``), evaluates its val rows, and
the val loss and detections are merged so that every rank logs and
decides alike; rank 0 writes the checkpoints. Each rank runs on
``cuda:LOCAL_RANK`` unless ``--device`` names a device (``--device cuda:0
--dist-backend gloo`` puts two ranks on one card). With ``--log-file``,
rank r > 0 writes to ``<log-file>.rank<r>``.
"""
from __future__ import annotations

import argparse
import os
import time
from collections import defaultdict
from typing import Any, Optional

import numpy as np


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--exp", default="test")
    p.add_argument("--model", default="efficientdet_d0")
    p.add_argument("--num-classes", type=int, default=90)
    p.add_argument("--image-size", type=int, default=None)
    p.add_argument("--fpn-repeats", type=int, default=None,
                   help="override fpn_cell_repeats (smoke tests)")
    p.add_argument("--head-repeats", type=int, default=None,
                   help="override box_class_repeats (smoke tests)")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--lr", type=float, default=0.09)
    p.add_argument("--warmup-steps", type=int, default=200)
    p.add_argument("--clip-grad", type=float, default=10.0)
    p.add_argument("--ema-decay", type=float, default=0.9998)
    p.add_argument("--remat", type=int, default=0,
                   help="gradient-checkpoint the first N backbone stages")
    p.add_argument("--remat-fpn-heads", action="store_true",
                   help="gradient-checkpoint the FPN cells + heads too")
    p.add_argument("--remat-cls-loss", action="store_true",
                   help="recompute the class focal loss in bwd instead of "
                        "saving its residuals (for memory-bound configs)")
    p.add_argument("--val-freq", type=int, default=50)
    p.add_argument("--val-steps", type=int, default=4)
    p.add_argument("--log-freq", type=int, default=10)
    p.add_argument("--alpha", type=float, default=0.15)
    p.add_argument("--gamma", type=float, default=0.0)
    p.add_argument("--bbox-coeff", type=float, default=50.0)
    p.add_argument("--checkpoint-dir", default="checkpoints")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--data", default="synthetic",
                   help="'synthetic' or a COCO annotation JSON path "
                        "(or the dataset root when --dataset is set)")
    p.add_argument("--data-dir", default="", help="image dir for COCO data")
    p.add_argument("--dataset", default="",
                   help="named dataset under --data root: coco2017 | "
                        "voc2007 | voc0712 | openimages-v5 | ... "
                        "(reference dataset factory). VOC val keeps "
                        "difficult-marked GT; OpenImages val keeps "
                        "group-of GT — both flow into the evaluator")
    p.add_argument("--evaluator", default="",
                   help="evaluator for --eval-map: pascal | "
                        "weighted_pascal | openimages | coco "
                        "(default: by dataset)")
    p.add_argument("--stream", action="store_true",
                   help="category-balanced infinite episode stream with "
                        "interleaved val blocks (reference PretrainDataset, "
                        "preloader.py:62-92) instead of epoch loaders")
    p.add_argument("--num-train-cats", type=int, default=0,
                   help="stream mode: top-N categories by image count "
                        "train (0 = two thirds)")
    p.add_argument("--num-val-cats", type=int, default=0)
    p.add_argument("--workers", type=int, default=4)
    p.add_argument("--eval-map", action="store_true",
                   help="run the PASCAL evaluator on val batches")
    p.add_argument("--per-cat-dir", default="per_cat_metrics")
    p.add_argument("--mesh", type=int, default=-1,
                   help="processes on the data axis (-1 = all of the "
                        "torchrun launch; one process outside torchrun)")
    p.add_argument("--dist-backend", default=None, choices=("nccl", "gloo"),
                   help="process-group backend (default: nccl on the card, "
                        "gloo on the CPU; gloo lets ranks share one card)")
    p.add_argument("--freeze-bn", choices=("none", "backbone", "all"),
                   default="backbone",
                   help="BN eval-mode scope. The reference DEFAULTS to "
                        "frozen backbone BN (freeze_bb_bn=True, "
                        "pretrain.py:51,169-176); 'none' trains all BN")
    p.add_argument("--no-train-bb", action="store_true",
                   help="backbone LR 0; FPN LR 0 until --lr-rewarm-step "
                        "(reference train_bb=False groups + the iter-200 "
                        "LR re-warm, pretrain.py:179-187,279-281)")
    p.add_argument("--no-train-fpn", action="store_true",
                   help="FPN param-group LR 0 (reference train_fpn=False, "
                        "pretrain.py:53,179-187)")
    p.add_argument("--lr-rewarm-step", type=int, default=200)
    p.add_argument("--opt", default="momentum",
                   choices=("adam", "adamw", "momentum"),
                   help="optimizer (reference optim flag, pretrain.py:48; "
                        "the reference drivers default to adam)")
    p.add_argument("--dropout", type=float, default=0.0,
                   help="backbone stochastic-depth drop_path_rate")
    p.add_argument("--random-trans", action="store_true",
                   help="--stream: jitter+flip train transforms instead of "
                        "letterbox-only (reference random_trans, "
                        "preloader.py:71-76)")
    p.add_argument("--re-prob", type=float, default=0.0,
                   help="RandomErasing probability (train loader)")
    p.add_argument("--interpolation", default=None)
    p.add_argument("--mean", type=float, nargs="+", default=None)
    p.add_argument("--std", type=float, nargs="+", default=None)
    p.add_argument("--fill-color", default=None)
    p.add_argument("--wandb", action="store_true",
                   help="mirror metrics to wandb (reference pretrain.py:72-77)")
    p.add_argument("--log-file", default="",
                   help="also append JSON metric lines to this file")
    p.add_argument("--profile-dir", default="",
                   help="capture a torch.profiler trace of steps 10-15 here")
    p.add_argument("--device", default=None,
                   help="the CUDA card when not given; 'cpu' runs the "
                        "kernels' plain versions")
    return p


def make_loaders(args, model_cfg, device, mesh=None):
    from ..data.dataset import (DetectionDataset, PrefetchLoader,
                                SyntheticDetectionDataset)
    from ..data.input_config import resolve_input_config
    from ..data.parsers import CocoParser
    from ..data.transforms import transforms_coco_eval, transforms_coco_train

    icfg = resolve_input_config(args, model_cfg)
    size = icfg["image_size"]
    if args.dataset:
        # named dataset under the --data root; val keeps the
        # evaluator-flagged GT (VOC difficult / OpenImages group-of)
        from ..data.dataset_factory import create_dataset, eval_flag_kwargs
        train_ds = create_dataset(args.dataset, args.data, splits="train")
        val_ds = create_dataset(args.dataset, args.data, splits="val",
                                **eval_flag_kwargs(args.dataset))
        train_ds.transform = transforms_coco_train(
            size, fill_color=icfg["fill_color"])
        val_ds.transform = transforms_coco_eval(
            size, interpolation=icfg["interpolation"],
            fill_color=icfg["fill_color"])
    elif args.data == "synthetic":
        train_ds = SyntheticDetectionDataset(
            num_images=max(args.batch_size * 16, 256), image_size=size,
            num_classes=model_cfg.num_classes, seed=0)
        val_ds = SyntheticDetectionDataset(
            num_images=args.batch_size * args.val_steps, image_size=size,
            num_classes=model_cfg.num_classes, seed=1)
    else:
        parser = CocoParser(args.data)
        train_ds = DetectionDataset(
            args.data_dir, parser,
            transforms_coco_train(size, fill_color=icfg["fill_color"]))
        val_ds = DetectionDataset(
            args.data_dir, parser,
            transforms_coco_eval(size, interpolation=icfg["interpolation"],
                                 fill_color=icfg["fill_color"]))
    # data parallelism: each process its stride of the samples
    split = dict(process_index=mesh.rank, process_count=mesh.size) \
        if mesh is not None else {}
    train = PrefetchLoader(train_ds, args.batch_size, shuffle=True,
                           workers=args.workers, device=device,
                           mean=icfg["mean"], std=icfg["std"],
                           re_prob=args.re_prob, **split)
    # drop_last=False: the val metrics cover the whole split
    val = PrefetchLoader(val_ds, args.batch_size, shuffle=False,
                         workers=args.workers, device=device,
                         drop_last=False, mean=icfg["mean"], std=icfg["std"],
                         **split)
    return train, val


def make_stream(args, model_cfg, mesh=None):
    """Category-balanced episode stream with interleaved val blocks
    (reference PretrainDataset, preloader.py:28-150)."""
    from ..data.episodic import SyntheticEpisodeSource
    from ..data.parsers import CocoParser
    from ..data.pretrain_stream import (ParserQuerySource,
                                        PretrainEpisodeStream,
                                        split_categories_by_count)

    size = model_cfg.image_size
    if args.data == "synthetic":
        src = SyntheticEpisodeSource(
            num_cats=model_cfg.num_classes, img_hw=size)
        counts = {c: len(src.images_for(c))
                  for c in range(1, model_cfg.num_classes + 1)}
    else:
        parser = CocoParser(args.data)
        src = ParserQuerySource(args.data_dir, parser)
        counts = src.category_counts()
    cats = sorted(counts)
    n_train = args.num_train_cats or max(1, len(cats) * 2 // 3)
    n_val = args.num_val_cats or max(1, len(cats) - n_train)
    train_cats, val_cats = split_categories_by_count(counts, n_train, n_val)
    return PretrainEpisodeStream(
        src, size, train_cats, val_cats, num_qry=args.batch_size,
        val_freq=args.val_freq, num_val_batches=args.val_steps,
        random_trans=args.random_trans,
        process_index=mesh.rank if mesh is not None else 0,
        process_count=mesh.size if mesh is not None else 1)


def main(argv=None, *, init_variables: Optional[Any] = None):
    """Run the driver. ``init_variables``: a JAX ``TrainState`` (or a dict
    of its fields) to start from instead of the seeded weights, carried
    across by ``utils.from_jax.load_jax_train_state`` (the JAX driver
    draws its weights from ``jax.random.key(0)``; this lets a port run
    start from the same numbers). Returns the final ``TrainState``."""
    args = build_argparser().parse_args(argv)
    from ..parallel import create_mesh
    mesh = create_mesh((args.mesh,), ("data",), device=args.device,
                       backend=args.dist_backend)
    try:
        return _run(args, mesh, init_variables)
    finally:
        mesh.close()


def _run(args, mesh, init_variables):
    import torch
    from torch.func import functional_call

    from ..config import get_efficientdet_config
    from ..config.train_config import TrainConfig
    from ..data.device_preproc import normalize_uint8
    from ..factory import create_model_from_config
    from ..ops.anchors import Anchors
    from ..ops.post_process import generate_detections
    from ..parallel import process_merge
    from ..utils.profiling import MetricLogger, span, start_trace, stop_trace
    from .checkpoint import CheckpointManager
    from .train_state import (create_train_state, detection_eval_step,
                              linear_schedule, make_grouped_optimizer,
                              make_train_step)

    device = mesh.device
    model_cfg = get_efficientdet_config(
        args.model, num_classes=args.num_classes,
        alpha=args.alpha, gamma=args.gamma, box_loss_weight=args.bbox_coeff)
    if args.image_size:
        model_cfg = model_cfg.replace(
            image_size=(args.image_size, args.image_size))
    if args.fpn_repeats:
        model_cfg = model_cfg.replace(fpn_cell_repeats=args.fpn_repeats)
    if args.head_repeats:
        model_cfg = model_cfg.replace(box_class_repeats=args.head_repeats)
    if args.dropout > 0:
        model_cfg = model_cfg.replace(backbone_args={
            **(model_cfg.backbone_args or {}),
            "drop_path_rate": args.dropout})
    if args.remat:
        model_cfg = model_cfg.replace(backbone_args={
            **(model_cfg.backbone_args or {}), "remat_stages": args.remat})
    if args.remat_fpn_heads:
        model_cfg = model_cfg.replace(remat_fpn=True, remat_heads=True)

    tcfg = TrainConfig(
        opt=args.opt, lr=args.lr, clip_grad_norm=args.clip_grad,
        ema_decay=args.ema_decay, batch_size=args.batch_size,
        checkpoint_dir=args.checkpoint_dir,
        remat_cls_loss=args.remat_cls_loss)
    model = create_model_from_config(model_cfg, seed=0, device=device)
    anchors = Anchors.from_config(model_cfg)
    print(f"device: {device}; mesh: {mesh.size} process(es), rank "
          f"{mesh.rank}", flush=True)

    schedule = linear_schedule(1e-4, args.lr, args.warmup_steps)
    tx = None
    if args.no_train_bb or args.no_train_fpn:
        # per-group LRs (reference param groups + iter-200 re-warm,
        # pretrain.py:179-187,279-281): backbone off with --no-train-bb;
        # fpn off with --no-train-fpn, else gated until the re-warm step
        # when the backbone is frozen; heads always on
        rewarm = args.lr_rewarm_step

        def off(step):
            return 0.0

        def gated(step):
            return schedule(step) if step >= rewarm else 0.0

        if args.no_train_fpn:
            fpn_sched = off
        elif args.no_train_bb:
            fpn_sched = gated
        else:
            fpn_sched = schedule
        tx = make_grouped_optimizer(tcfg, {
            "backbone": off if args.no_train_bb else schedule,
            "fpn": fpn_sched,
            "heads": schedule,
        }, model)
    state, tx = create_train_state(model, tcfg, lr_schedule=schedule, tx=tx)
    if init_variables is not None:
        from ..utils.from_jax import load_jax_train_state
        load_jax_train_state(state, init_variables)
    step_fn = make_train_step(model, tx, anchors, tcfg, mesh=mesh,
                              freeze_bn=args.freeze_bn)
    anchor_boxes = torch.from_numpy(anchors.boxes).to(device)

    @torch.no_grad()
    def detect(images):
        """The EMA model's detections on the card (K1: hard NMS)."""
        was_training = model.training
        model.eval()
        try:
            cls_out, box_out = functional_call(
                model, state.variables(use_ema=True), (images,))
        finally:
            model.train(was_training)
        dets, _ = generate_detections(
            cls_out, box_out, anchors, num_classes=model_cfg.num_classes,
            max_detection_points=model_cfg.max_detection_points,
            max_det_per_image=model_cfg.max_det_per_image,
            soft_nms=model_cfg.soft_nms, topk_method=model_cfg.topk_method)
        return dets

    ckpt = CheckpointManager(tcfg.checkpoint_dir, keep=3, mesh=mesh)
    start_step = 0
    if args.resume and ckpt.latest_step() is not None:
        state = ckpt.restore(state)
        start_step = state.step
        print(f"resumed from step {start_step}", flush=True)

    evaluator = None
    if args.eval_map:
        from ..evaluation import create_evaluator, default_evaluator_name
        # each rank evaluates its val rows; the evaluator gathers every
        # rank's before adding them (reference evaluator.py:36-39)
        evaluator = create_evaluator(
            args.evaluator or default_evaluator_name(args.dataset),
            model_cfg.num_classes, distributed=mesh.size > 1)
    os.makedirs(args.per_cat_dir, exist_ok=True)

    log_file = args.log_file
    if log_file and mesh.rank > 0:
        log_file = f"{log_file}.rank{mesh.rank}"
    logger = MetricLogger(use_wandb=args.wandb, project="ood-detection-tpu",
                          run_name=args.exp, config=vars(args),
                          out_file=log_file or None)

    metrics_acc = defaultdict(float)
    best_val = float("inf")
    step = start_step
    t0 = time.time()

    def eval_batch(vbatch):
        """One val batch -> loss; detections feed the evaluator thread."""
        model_batch = {k: vbatch[k] for k in ("image", "bbox", "cls")}
        vm = detection_eval_step(model, anchor_boxes, state, model_batch,
                                 mesh=mesh)
        if evaluator is not None:
            target = {k: vbatch[k]
                      for k in ("bbox", "cls", "img_id", "difficult",
                                "group_of") if k in vbatch}
            evaluator.add_predictions_async(detect(model_batch["image"]),
                                            target)
        return float(vm["loss"])

    def finish_val(val_losses):
        nonlocal best_val
        # every rank saw its own val rows: the count-weighted merge gives
        # every rank the same val loss, so the best-checkpoint decision
        # is the same everywhere
        sums = process_merge(np.array([np.sum(val_losses), len(val_losses)],
                                      np.float64), mesh)
        tot, cnt = sums.reshape(-1, 2).sum(axis=0)
        val_loss = float(tot / cnt) if cnt else float("inf")
        val_log = {"step": step, "val_loss": round(val_loss, 5)}
        if evaluator is not None:
            evaluator.drain()
            res = evaluator.evaluate()
            val_log["val_mAP"] = round(float(res["mAP@0.5IOU"]), 5)
            val_log["val_CorLoc"] = round(float(res["meanCorLoc@0.5IOU"]), 5)
            if mesh.rank == 0:      # every rank holds the same merged result
                np.save(os.path.join(
                    args.per_cat_dir, f"{args.exp}_ap_{step}.npy"),
                    res["per_class_ap"])
                np.save(os.path.join(
                    args.per_cat_dir, f"{args.exp}_corloc_{step}.npy"),
                    res["per_class_corloc"])
            evaluator.reset()
        logger.log(val_log)
        if val_loss < best_val:
            best_val = val_loss
            ckpt.save(step, state, metrics={"val_loss": val_loss})
            logger.log({"step": step, "saved_best": best_val})

    prof = None

    def train_batch(batch):
        nonlocal state, metrics_acc, t0, prof
        if args.profile_dir:
            if step == start_step + 10:
                prof = start_trace()
            elif step == start_step + 15 and prof is not None:
                stop_trace(prof, args.profile_dir)
                prof = None
        batch = {k: batch[k] for k in ("image", "bbox", "cls")}
        with span("odt.step"):
            state, metrics = step_fn(state, batch)
        for k, v in metrics.items():
            metrics_acc[k] += float(v)
        if (step + 1) % args.log_freq == 0:
            avg = {k: v / args.log_freq for k, v in metrics_acc.items()}
            rate = args.batch_size * args.log_freq / (time.time() - t0)
            logger.log({"step": step + 1,
                        "img_per_sec": round(rate, 1),
                        **{k: round(v, 5) for k, v in avg.items()}})
            metrics_acc = defaultdict(float)
            t0 = time.time()

    if args.stream:
        # interleaved-val episode stream (reference PretrainDataset,
        # preloader.py:62-92): val blocks arrive inline as val_iter batches
        stream = make_stream(args, model_cfg, mesh)
        val_losses: list = []
        in_val = False
        for batch in stream:
            if step >= args.steps:
                break
            is_val = bool(batch.pop("val_iter"))
            for k in ("image", "bbox", "cls"):
                batch[k] = torch.from_numpy(batch[k]).to(device)
            batch["image"] = normalize_uint8(batch["image"])
            if is_val:
                in_val = True
                val_losses.append(eval_batch(batch))
                continue
            if in_val:           # val block just ended -> summarize
                finish_val(val_losses)
                val_losses = []
                in_val = False
            train_batch(batch)
            step += 1
        if in_val and val_losses:
            # step limit hit inside a val block: keep the collected losses
            # and the evaluator's queued predictions
            finish_val(val_losses)
    else:
        train_loader, val_loader = make_loaders(args, model_cfg, device,
                                                mesh)
        train_iter = iter(train_loader)
        while step < args.steps:
            try:
                batch = next(train_iter)
            except StopIteration:
                train_iter = iter(train_loader)
                batch = next(train_iter)
            train_batch(batch)
            step += 1
            if step % args.val_freq == 0:
                val_losses = []
                for vi, vbatch in enumerate(val_loader):
                    if vi >= args.val_steps:
                        break
                    val_losses.append(eval_batch(vbatch))
                finish_val(val_losses)

    if prof is not None:      # run ended before the step-15 stop point
        stop_trace(prof, args.profile_dir)
    ckpt.save(step, state)
    ckpt.wait()
    logger.log({"final_step": step, "best_val": best_val})
    logger.close()
    return state


if __name__ == "__main__":
    main()
