"""Episodic meta-training / open-set adaptation driver (port of
``ood_object_detection_tpu.meta.train_driver``).

The reference infer.py:102-866 two-phase run: projection pretraining
episodes (phase A), then MAML meta-training (phase B) with per-episode
mAP / CorLoc and open-set AUROC / FPR95 on validation episodes,
meta-batch accumulation and best-val checkpointing of the meta
parameters (class head, ProjectionNet, inner LRs). Episodes are built on
a background thread (``--prefetch-episodes``), labelled on the card (K3
-> K4); the adapted head's detections go through K1 (hard NMS).

Run: python -m ood_object_detection_tpu_torch.meta.train_driver --help
(defaults drive the synthetic episode source; point --coco-ann/--data-dir
at a dataset for real runs). It runs on the CUDA card, and raises without
one, unless ``--device cpu`` is given (the kernels' plain versions).
``--load-ckpt`` reads a variables file of the port
(``train.checkpoint.save_variables``), not an orbax directory.

Episode parallelism: one process a card under torchrun (``python -m
torch.distributed.run --nproc-per-node N -m
ood_object_detection_tpu_torch.meta.train_driver --episode-mesh N ...``).
``--episode-mesh`` must divide ``--meta-batch-size``; each rank builds
its own episode stream (seed ``seed * N + rank``), buffers its
meta_batch_size / N training episodes and takes the meta step of
``MetaTrainer.train_meta_batch_sharded`` (one all-reduce, the same update
on every rank), in phase A as in phase B. Each rank validates on its own
episodes and the val loss is averaged over the ranks before the
best-checkpoint decision; rank 0 writes the checkpoints. Each rank runs
on ``cuda:LOCAL_RANK`` unless ``--device`` names a device.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from collections import defaultdict
from typing import Any, Optional

import numpy as np


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--exp", default="meta")
    p.add_argument("--model", default="efficientdet_d0")
    p.add_argument("--img-size", type=int, default=256)
    p.add_argument("--qry-img-size", type=int, default=640)
    p.add_argument("--n-way", type=int, default=1)
    p.add_argument("--num-sup", type=int, default=25)
    p.add_argument("--num-qry", type=int, default=25)
    p.add_argument("--num-zero-images", type=int, default=6)
    p.add_argument("--meta-batch-size", type=int, default=4)
    p.add_argument("--proj-iters", type=int, default=10000)
    p.add_argument("--steps", type=int, default=1, help="inner steps")
    p.add_argument("--inner-lr", type=float, default=0.1)
    p.add_argument("--meta-lr", type=float, default=0.001)
    p.add_argument("--meta-clip", type=float, default=10.0)
    p.add_argument("--separate-head", action="store_true",
                   help="second pointwise class-predict head: support BCE "
                        "on its logits, gating on the main head's, main "
                        "predict pw frozen in the inner loop, meta groups "
                        "sep-at-meta_lr / rest staged (reference "
                        "--separate_head, infer.py:203-204,259-274,560)")
    p.add_argument("--learn-inner", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="meta-train the per-layer inner LRs (enabled at "
                        "--lr-stage-step like the reference, "
                        "infer.py:280-282,815-818)")
    p.add_argument("--lr-lr", type=float, default=None,
                   help="constant meta-LR for the inner-LR group, "
                        "overriding the staged enable")
    p.add_argument("--lr-stage-step", type=int, default=61,
                   help="meta updates before the staged groups switch "
                        "from 0 to --meta-lr (reference fires after 61, "
                        "infer.py:815-818)")
    p.add_argument("--only-final", action="store_true",
                   help="inner loop adapts only the predict pointwise "
                        "params (reference only_final, infer.py:663)")
    p.add_argument("--multi-inner", action=argparse.BooleanOptionalAction,
                   default=True, help="per-layer inner LRs")
    p.add_argument("--freeze-bb-bn", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="backbone BNs eval-mode in episodes; --no-* runs "
                        "them on batch stats (infer.py:323-337)")
    p.add_argument("--freeze-fpn-bn", action=argparse.BooleanOptionalAction,
                   default=True, help="FPN BN mode (see --freeze-bb-bn)")
    p.add_argument("--freeze-box-bn", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="box-head BN mode (see --freeze-bb-bn)")
    p.add_argument("--train-bb", action="store_true",
                   help="meta-grads flow into backbone features "
                        "(infer.py:344-345)")
    p.add_argument("--train-fpn", action="store_true",
                   help="meta-grads flow into FPN features "
                        "(infer.py:347-348)")
    p.add_argument("--sim-thresh", type=float, default=0.2)
    p.add_argument("--sim-target", default="max", choices=["max", "avg"])
    p.add_argument("--loss-mode", default="separate",
                   choices=["separate", "same", "no_conf"])
    p.add_argument("--proj-depth", type=int, default=2)
    p.add_argument("--proj-size", type=int, default=512)
    p.add_argument("--proj-coeff", type=float, default=30.0)
    p.add_argument("--obj-coeff", type=float, default=0.0001)
    p.add_argument("--proj-reg", type=float, default=0.03)
    p.add_argument("--random-trans", action="store_true",
                   help="jitter+flip train-query transforms instead of "
                        "letterbox-only (reference random_trans, "
                        "dataloader.py:58-61)")
    p.add_argument("--supp-aug", action="store_true",
                   help="augment train supports with (0.8, 1.5) scale "
                        "jitter + flip (reference supp_aug, "
                        "dataloader.py:114-115)")
    p.add_argument("--ref-pos-enc", action="store_true",
                   help="reference-exact anchor positional encodings: "
                        "interleaved cell encoding + [feat|anch|lev|cell] "
                        "row layout (infer.py:370-377); default is the "
                        "clean concat(enc_y, enc_x) form")
    p.add_argument("--ref-stale-proj-activs", action="store_true",
                   help="reference-exact phase-B projection regularizer: "
                        "re-embed the LAST phase-A episode's activations "
                        "instead of the current episode's proj crops "
                        "(infer.py:349-359)")
    p.add_argument("--total-iters", type=int, default=100)
    p.add_argument("--val-freq", type=int, default=400)
    p.add_argument("--log-freq", type=int, default=10)
    p.add_argument("--load-ckpt", default="",
                   help="a variables file of the port (save_variables)")
    p.add_argument("--checkpoint-dir", default="meta_checkpoints")
    p.add_argument("--synthetic-cats", type=int, default=6)
    p.add_argument("--eval-map", action="store_true",
                   help="per-episode mAP/CorLoc on validation episodes "
                        "(reference infer.py:689-700)")
    p.add_argument("--per-cat-dir", default="per_cat_metrics")
    p.add_argument("--eval-ood", action="store_true",
                   help="open-set evaluation during val blocks: energy "
                        "AUROC/FPR95 of known-category (train split, eval "
                        "transforms) vs held-out-category episodes, at "
                        "detection level and over GT-region anchors "
                        "(BASELINE open-set config; reference "
                        "infer.py:689-700 eval loop)")
    p.add_argument("--ood-method", default="energy",
                   choices=["energy", "msp", "max_logit"],
                   help="per-anchor OOD score for --eval-ood")
    # real-data episodic sources
    p.add_argument("--coco-ann", default="",
                   help="COCO annotation JSON: queries come from this "
                        "dataset instead of the synthetic source")
    p.add_argument("--data-dir", default="",
                   help="image directory for --coco-ann")
    p.add_argument("--support-dir", default="",
                   help="per-category support-image directory tree "
                        "(root/<category name>/*, the reference web-image "
                        "glob, dataloader.py:274-276); defaults to query "
                        "images of the category when unset")
    p.add_argument("--num-train-cats", type=int, default=0,
                   help="categories (by image count) for training; "
                        "0 = two thirds of all")
    p.add_argument("--num-val-cats", type=int, default=0,
                   help="held-out categories for validation episodes")
    p.add_argument("--prefetch-episodes", type=int, default=2,
                   help="episodes assembled ahead on a background thread "
                        "(0 = synchronous; the reference's preloader "
                        "worker analog, preloader.py:153-278)")
    p.add_argument("--episode-mesh", type=int, default=0,
                   help="processes of the episode-parallel meta step (the "
                        "torchrun launch's; 0 or 1: sequential "
                        "accumulation in one process)")
    p.add_argument("--dist-backend", default=None, choices=("nccl", "gloo"),
                   help="process-group backend (default: nccl on the card, "
                        "gloo on the CPU; gloo lets ranks share one card)")
    p.add_argument("--fpn-repeats", type=int, default=None,
                   help="override fpn_cell_repeats (small-scale debugging)")
    p.add_argument("--head-repeats", type=int, default=None,
                   help="override box_class_repeats (small-scale debugging)")
    p.add_argument("--device", default=None,
                   help="the CUDA card when not given; 'cpu' runs the "
                        "kernels' plain versions")
    return p


def load_checkpoint(model, path: str, separate_head: bool) -> None:
    """Load a port variables file into ``model``; without the separate
    head's tensors in the file, keep the fresh head (the reference loads
    weights before add_head, infer.py:198-204)."""
    from ..train.checkpoint import restore_variables
    state = model.state_dict()
    try:
        model.load_state_dict(restore_variables(path, state))
    except ValueError:
        if not separate_head:
            raise
        rest = {k: v for k, v in state.items()
                if not k.startswith("class_net.predict_sep.")}
        model.load_state_dict(restore_variables(path, rest), strict=False)


def main(argv=None, *, init_variables: Optional[Any] = None):
    """Run the driver. ``init_variables``: ``{"variables": the JAX model's
    {"params", "batch_stats"}, "proj_params": the JAX ProjectionNet's
    params with dot_mult / dot_add}`` to start from instead of the seeded
    weights (the JAX driver draws them from ``jax.random.key(0)`` and
    ``key(1)``), carried across by ``utils.from_jax``. Returns the
    ``MetaTrainer`` at the end of the run."""
    args = build_argparser().parse_args(argv)
    if args.episode_mesh > 1 and args.meta_batch_size % args.episode_mesh:
        raise SystemExit("--episode-mesh must divide --meta-batch-size")
    from ..parallel import create_mesh
    mesh = create_mesh((max(args.episode_mesh, 1),), ("episode",),
                       device=args.device, backend=args.dist_backend)
    try:
        return _run(args, mesh, init_variables)
    finally:
        mesh.close()


def _run(args, mesh, init_variables):
    import torch

    from ..config import get_efficientdet_config
    from ..data.episodic import (EpisodePrefetcher, EpisodicDataset,
                                 SyntheticEpisodeSource)
    from ..evaluation import OodEvaluator, PascalEvaluator
    from ..factory import create_model_from_config
    from ..parallel import process_merge
    from ..train.checkpoint import CheckpointManager
    from . import MetaConfig, MetaTrainer, ProjectionNet

    device = mesh.device
    meta_cfg = MetaConfig(
        n_way=args.n_way, num_sup=args.num_sup, num_qry=args.num_qry,
        num_zero_images=args.num_zero_images,
        meta_batch_size=args.meta_batch_size, img_size=args.img_size,
        qry_img_size=args.qry_img_size, proj_iters=args.proj_iters,
        steps=args.steps, inner_lr=args.inner_lr, meta_lr=args.meta_lr,
        meta_clip=args.meta_clip, sim_thresh=args.sim_thresh,
        sim_target=args.sim_target, loss_mode=args.loss_mode,
        proj_depth=args.proj_depth, proj_size=args.proj_size,
        proj_coeff=args.proj_coeff, obj_coeff=args.obj_coeff,
        proj_reg=args.proj_reg,
        random_trans=args.random_trans, supp_aug=args.supp_aug,
        ref_pos_enc=args.ref_pos_enc,
        ref_stale_proj_activs=args.ref_stale_proj_activs,
        separate_head=args.separate_head, learn_inner=args.learn_inner,
        lr_stage_step=args.lr_stage_step, only_final=args.only_final,
        multi_inner=args.multi_inner,
        freeze_bb_bn=args.freeze_bb_bn, freeze_fpn_bn=args.freeze_fpn_bn,
        freeze_box_bn=args.freeze_box_bn,
        train_bb=args.train_bb, train_fpn=args.train_fpn)

    # the meta task is binary (task-object vs not): num_classes=1
    # (reference swaps in MetaHead with num_classes=1, infer.py:191-193)
    model_cfg = get_efficientdet_config(
        args.model, num_classes=1,
        image_size=(args.qry_img_size, args.qry_img_size),
        separate_head=args.separate_head)
    if args.fpn_repeats is not None:
        model_cfg = model_cfg.replace(fpn_cell_repeats=args.fpn_repeats)
    if args.head_repeats is not None:
        model_cfg = model_cfg.replace(box_class_repeats=args.head_repeats)
    model = create_model_from_config(model_cfg, seed=0, device=device)
    proj_net = ProjectionNet(
        fpn_channels=model_cfg.fpn_channels, width=args.proj_size,
        depth=args.proj_depth, dot_mult_init=meta_cfg.dot_mult,
        dot_add_init=meta_cfg.dot_add)
    proj_net.init_weights(torch.Generator().manual_seed(1))
    if init_variables is not None:
        from ..utils.from_jax import load_jax_projection, load_jax_variables
        load_jax_variables(model, init_variables["variables"])
        load_jax_projection(proj_net, init_variables["proj_params"])
    if args.load_ckpt:
        load_checkpoint(model, args.load_ckpt, args.separate_head)

    if args.coco_ann:
        # real-data episodes: COCO-format queries (+ optional directory
        # support source — the reference's per-category web-image glob)
        from ..data.metadata import directory_support_source
        from ..data.parsers import CocoParser
        from ..data.pretrain_stream import (ParserQuerySource,
                                            split_categories_by_count)

        parser = CocoParser(args.coco_ann)
        src = ParserQuerySource(args.data_dir, parser)
        counts = src.category_counts()
        cats = sorted(counts)
        n_train = args.num_train_cats or max(1, len(cats) * 2 // 3)
        n_val = args.num_val_cats or max(1, len(cats) - n_train)
        train_cats, val_cats = split_categories_by_count(
            counts, n_train, n_val)
        val_cats = val_cats or train_cats
        if args.support_dir:
            # labels are 1-based indices into the parser's category list
            cat_names = {c: parser.cat_names[c - 1] for c in cats} \
                if getattr(parser, "cat_names", None) else \
                {c: str(c) for c in cats}
            support = directory_support_source(args.support_dir, cat_names)
            empty = [c for c in cats if not support.get(c)]
            if empty:
                raise SystemExit(
                    f"--support-dir has no images for categories {empty}")
        else:
            # query images as supports, loaded lazily per category
            from ..data.episodic import QuerySupportFallback
            support = QuerySupportFallback(src, cats)
    else:
        src = SyntheticEpisodeSource(num_cats=args.synthetic_cats,
                                     img_hw=(args.img_size, args.img_size))
        cats = list(range(1, args.synthetic_cats + 1))
        train_cats = cats[:max(1, len(cats) * 2 // 3)]
        val_cats = cats[max(1, len(cats) * 2 // 3):] or train_cats
        support = src.support_source(cats)
    dataset = EpisodicDataset(
        support, src, model_cfg, meta_cfg,
        train_cats=train_cats, val_cats=val_cats, val_freq=args.val_freq,
        device=device, process_index=mesh.rank, process_count=mesh.size)

    trainer = MetaTrainer(
        model, proj_net, meta_cfg, model_cfg,
        dataset.builder.proj_level_sizes, lr_lr=args.lr_lr, device=device)

    ckpt = CheckpointManager(args.checkpoint_dir, keep=3, mesh=mesh)
    evaluator = PascalEvaluator(num_classes=1) if args.eval_map else None
    det_ood_ev = gt_ood_ev = None
    if args.eval_ood:
        det_ood_ev, gt_ood_ev = OodEvaluator(), OodEvaluator()

    def score_ood_episode(episode, is_known: bool):
        """Accumulate one episode's open-set scores: detection-level plus
        GT-region (best-IoU anchor) energies from the adapted head."""
        dets, det_ood, gt_ood, gt_valid = (
            t.cpu().numpy() for t in trainer.episode_ood_scores(
                episode, ood_method=args.ood_method))
        keep = dets[..., 4] > 0.02      # low bar: include weak detections
        scores = det_ood[keep]
        det_ood_ev.add_predictions(
            scores, {"is_known": np.full(len(scores), is_known)})
        gt_scores = gt_ood[gt_valid]
        gt_ood_ev.add_predictions(
            gt_scores, {"is_known": np.full(len(gt_scores), is_known)})

    os.makedirs(args.per_cat_dir, exist_ok=True)
    acc = defaultdict(float)
    val_acc = defaultdict(float)
    val_count = 0
    val_det_count = 0    # val episodes that produced detection metrics
    best_val = float("inf")
    best_is_proj = True   # best_val tracks proj_loss until the phase flips
    t0 = time.time()
    it = 0
    episode_buf, buf_phase = [], None
    episodes = (EpisodePrefetcher(dataset, depth=args.prefetch_episodes)
                if args.prefetch_episodes > 0 else dataset)
    for episode in episodes:
        if it >= args.total_iters:
            break
        it += 1
        phase_a = it <= meta_cfg.proj_iters
        if episode["val_iter"]:
            metrics = trainer.eval_episode(episode, phase_a)
            key = "proj_loss" if phase_a else "final_loss"
            vl = float(metrics[key])
            if best_is_proj and not phase_a:
                # phase flip: best_val tracked the proj objective, which
                # is incommensurate with the MAML query loss — reset so
                # phase-B "best" checkpoints are reachable
                best_val = float("inf")
                best_is_proj = False
            if evaluator is not None and not phase_a:
                # per-episode detection metrics on the adapted head
                # (reference infer.py:689-700): GT is binary class 1
                dets = trainer.episode_detections(episode)
                evaluator.add_predictions(
                    dets, {"bbox": episode["qry_gt_bbox"],
                           "cls": episode["qry_gt_cls"]})
                res = evaluator.evaluate()
                evaluator.reset()
                val_acc["val_mAP"] += float(res["mAP@0.5IOU"])
                val_acc["val_CorLoc"] += float(res["meanCorLoc@0.5IOU"])
                val_det_count += 1
                # per-category AP/CorLoc dumps (reference infer.py:842,861)
                np.save(os.path.join(args.per_cat_dir,
                                     f"{args.exp}_ap_{it}.npy"),
                        res["per_class_ap"])
                np.save(os.path.join(args.per_cat_dir,
                                     f"{args.exp}_corloc_{it}.npy"),
                        res["per_class_corloc"])
            if det_ood_ev is not None and not phase_a:
                # unknown arm: this held-out-category episode; known arm:
                # a fresh eval-transform episode over train categories
                score_ood_episode(episode, is_known=False)
                score_ood_episode(dataset.known_eval_episode(),
                                  is_known=True)
            # each rank ran its own val episode: average the loss so every
            # rank makes the same best-checkpoint decision
            vl = float(np.mean(process_merge(np.float64(vl), mesh)))
            val_acc["val_loss"] += vl
            val_count += 1
            if vl < best_val:
                best_val = vl
                ckpt.save(it, trainer.meta_params, metrics={"val_loss": vl})
        elif mesh.distributed:
            # episode-parallel meta batch: this rank's share of
            # meta_batch_size episodes, one all-reduce, one update; a
            # phase boundary drops a partial share, as train_episode does
            if buf_phase is not None and buf_phase != phase_a:
                episode_buf.clear()
            buf_phase = phase_a
            episode_buf.append(episode)
            if len(episode_buf) * mesh.size >= meta_cfg.meta_batch_size:
                metrics = trainer.train_meta_batch_sharded(
                    episode_buf, mesh, phase_a=phase_a)
                # meta-batch means standing for this rank's episodes:
                # scaled so acc / log_freq stays a per-episode average
                for k, v in metrics.items():
                    acc[k] += float(v) * len(episode_buf)
                episode_buf.clear()
        else:
            metrics = trainer.train_episode(episode, phase_a)
            for k, v in metrics.items():
                if k != "meta_step":
                    acc[k] += float(v)
        if it % args.log_freq == 0:
            avg = {k: round(v / args.log_freq, 5) for k, v in acc.items()}
            if val_count:
                # detection metrics exist only for phase-B val episodes —
                # average them over their own count, not all val episodes
                avg.update({
                    k: round(v / (val_det_count
                                  if k in ("val_mAP", "val_CorLoc")
                                  else val_count), 5)
                    for k, v in val_acc.items()})
                val_acc = defaultdict(float)
                val_count = 0
                val_det_count = 0
                if det_ood_ev is not None:
                    # block-level open-set metrics over the pooled scores
                    for name, ev in (("det", det_ood_ev), ("gt", gt_ood_ev)):
                        r = ev.evaluate()
                        for m in ("auroc", "fpr95"):
                            v = r[m]
                            avg[f"ood_{m}_{name}"] = (
                                round(float(v), 4)
                                if np.isfinite(v) else None)
                        ev.reset()
            print(json.dumps({
                "iter": it, "phase": "proj" if phase_a else "maml",
                "eps_per_sec": round(args.log_freq / (time.time() - t0), 3),
                **avg}), flush=True)
            acc = defaultdict(float)
            t0 = time.time()

    ckpt.save(it, trainer.meta_params)
    ckpt.wait()
    print(json.dumps({
        "final_iter": it,
        # math.inf serializes as bare `Infinity` (invalid JSON) — emit
        # null when no validation episode ever ran
        "best_val": best_val if best_val != float("inf") else None,
    }), flush=True)
    return trainer


if __name__ == "__main__":
    main()
