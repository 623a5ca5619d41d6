"""Offline evaluation entry point: checkpoint + dataset -> detection metrics.

Port of ``ood_object_detection_tpu.validate``: the loader decodes and
letterboxes on host threads with PIL and copies uint8 batches to the card,
which normalises them; ``DetBenchPredict`` runs there (K2 -> top-k -> K1
on bf16 logits); the asynchronous evaluator accumulates on a host thread;
one JSON metrics line is printed at the end. The final partial batch is
evaluated, never dropped.

Run::

    python -m ood_object_detection_tpu_torch.validate \\
        --model efficientdet_d0 --checkpoint model.pth \\
        --dataset coco2017 --data /datasets/coco [--evaluator coco]

It runs on the CUDA card, and raises without one, unless ``--device cpu``
is given (the kernels' plain versions). ``--checkpoint`` takes a
reference-format torch ``.pth`` / ``.pt`` (``--checkpoint-ema`` for its
EMA weights); with none the seeded random model is evaluated. ``--data
synthetic`` needs no files. ``--compute-dtype bfloat16`` runs the model in
bf16, the path of the hand-written K2; the default is the model config's
(float32), as in the JAX CLI.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Dict, Optional, Tuple


def build_argparser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model", default="efficientdet_d0")
    p.add_argument("--num-classes", type=int, default=90)
    p.add_argument("--checkpoint", default="",
                   help="reference-format torch .pth/.pt")
    p.add_argument("--checkpoint-ema", action="store_true",
                   help="load EMA weights from torch checkpoints "
                        "(reference use_ema, factory.py:46-47)")
    p.add_argument("--dataset", default="",
                   help="named dataset (coco2017, voc0712, openimages, ...)")
    p.add_argument("--data", default="synthetic",
                   help="dataset root / COCO json / 'synthetic'")
    p.add_argument("--data-dir", default="", help="image dir for COCO json")
    p.add_argument("--split", default="val")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--max-batches", type=int, default=0,
                   help="stop after N batches (0 = whole split)")
    p.add_argument("--workers", type=int, default=2)
    p.add_argument("--evaluator", default="",
                   help="pascal | weighted_pascal | precision_at_recall | "
                        "openimages | coco (default: by dataset)")
    p.add_argument("--ood-method", default="",
                   help="also score detections: energy | max_logit | msp")
    p.add_argument("--topk-method", default="per_anchor",
                   choices=["per_anchor", "approx", "exact"],
                   help="candidate top-k selection: per_anchor (fastest), "
                        "approx (reference pair semantics), exact "
                        "(reference pair semantics in two stages)")
    p.add_argument("--topk-recall", type=float, default=0.95,
                   help="kept for the JAX CLI's flags; the port's "
                        "selections are exact")
    p.add_argument("--image-size", type=int, default=0)
    p.add_argument("--interpolation", default=None)
    p.add_argument("--mean", type=float, nargs="+", default=None)
    p.add_argument("--std", type=float, nargs="+", default=None)
    p.add_argument("--fill-color", default=None)
    p.add_argument("--mesh", type=int, default=0,
                   help="data-parallel devices: 0 or 1 (one device); more "
                        "is not ported yet")
    p.add_argument("--out", default="", help="write the metrics JSON here")
    p.add_argument("--device", default=None,
                   help="the CUDA card when not given; 'cpu' runs the "
                        "kernels' plain versions")
    p.add_argument("--compute-dtype", default="",
                   choices=["", "float32", "bfloat16"],
                   help="model compute dtype (default: the model config's)")
    return p


def make_val_loader(args, model_cfg, device):
    from .data.dataset import (DetectionDataset, PrefetchLoader,
                               SyntheticDetectionDataset)
    from .data.input_config import resolve_input_config
    from .data.parsers import CocoParser
    from .data.transforms import transforms_coco_eval

    icfg = resolve_input_config(args, model_cfg)
    size = icfg["image_size"]
    if args.dataset:
        from .data.dataset_factory import create_dataset, eval_flag_kwargs
        ds = create_dataset(args.dataset, args.data, splits=args.split,
                            **eval_flag_kwargs(args.dataset))
        ds.transform = transforms_coco_eval(
            size, interpolation=icfg["interpolation"],
            fill_color=icfg["fill_color"])
    elif args.data == "synthetic":
        ds = SyntheticDetectionDataset(
            num_images=args.batch_size * max(args.max_batches, 4),
            image_size=size, num_classes=model_cfg.num_classes, seed=1)
    else:
        ds = DetectionDataset(
            args.data_dir, CocoParser(args.data),
            transforms_coco_eval(size, interpolation=icfg["interpolation"],
                                 fill_color=icfg["fill_color"]))
    # drop_last=False: evaluation covers the whole split, the final
    # partial batch included
    return PrefetchLoader(ds, args.batch_size, shuffle=False,
                          workers=args.workers, drop_last=False,
                          mean=icfg["mean"], std=icfg["std"], device=device)


TARGET_KEYS = ("bbox", "cls", "img_id", "difficult", "group_of")


def run_validation(bench, loader, evaluator, ood_method: Optional[str] = None,
                   max_batches: int = 0) -> Tuple[Dict, Dict]:
    """Predict every batch of ``loader`` with ``bench`` (a DetBenchPredict)
    and feed the evaluator's thread; then drain it and evaluate.

    Returns (metrics: the evaluator's scalar metrics rounded to 5 places,
    'images', 'img_per_sec' and, with ``ood_method``, 'ood_mean' /
    'ood_p95' over the kept detections; times: seconds spent waiting for
    the loader ('load_s'), predicting up to the detections' arrival on the
    host ('predict_s') and evaluating ('evaluate_s': handing batches to
    the evaluator, draining it and computing the metrics), and 'batches')."""
    import numpy as np

    n_images = n_batches = 0
    ood_acc = []
    times = dict(load_s=0.0, predict_s=0.0, evaluate_s=0.0)
    t0 = time.time()
    batches = iter(loader)
    while not max_batches or n_batches < max_batches:
        t = time.perf_counter()
        batch = next(batches, None)
        times["load_s"] += time.perf_counter() - t
        if batch is None:
            break
        t = time.perf_counter()
        out = bench(batch["image"])
        dets, ood = out if ood_method else (out, None)
        dets = dets.cpu().numpy()
        ood = ood.cpu().numpy() if ood is not None else None
        times["predict_s"] += time.perf_counter() - t
        t = time.perf_counter()
        evaluator.add_predictions_async(
            dets, {k: batch[k] for k in TARGET_KEYS if k in batch})
        if ood is not None:
            kept = dets[..., 4] > 0
            if kept.any():
                ood_acc.append(ood[kept])
        times["evaluate_s"] += time.perf_counter() - t
        n_images += int(batch["image"].shape[0])
        n_batches += 1
    batches.close()
    t = time.perf_counter()
    evaluator.drain()
    res = evaluator.evaluate()
    times["evaluate_s"] += time.perf_counter() - t
    times["batches"] = n_batches

    metrics = {k: round(float(v), 5) for k, v in res.items()
               if np.ndim(v) == 0}
    metrics["images"] = n_images
    metrics["img_per_sec"] = round(n_images / max(time.time() - t0, 1e-9), 2)
    if ood_acc:
        allo = np.concatenate(ood_acc)
        metrics["ood_mean"] = round(float(allo.mean()), 5)
        metrics["ood_p95"] = round(float(np.percentile(allo, 95)), 5)
    return metrics, times


def main(argv=None):
    args = build_argparser().parse_args(argv)
    if args.mesh > 1:
        raise NotImplementedError(
            f"--mesh {args.mesh}: data-parallel evaluation is not ported "
            "yet (ROADMAP Queue 1 item 7, data parallelism); use --mesh 1")

    import torch

    from .evaluation import create_evaluator, default_evaluator_name
    from .factory import create_model

    overrides = {}
    if args.image_size:
        overrides["image_size"] = (args.image_size, args.image_size)
    if args.compute_dtype:
        overrides["compute_dtype"] = args.compute_dtype
    bench = create_model(
        args.model, bench_task="predict", num_classes=args.num_classes,
        checkpoint_path=args.checkpoint, checkpoint_ema=args.checkpoint_ema,
        ood_method=args.ood_method or None, device=args.device,
        topk_method=args.topk_method, topk_recall=args.topk_recall,
        **overrides)
    device = next(bench.parameters()).device
    loader = make_val_loader(args, bench.config, device)
    evaluator = create_evaluator(
        args.evaluator or default_evaluator_name(args.dataset),
        bench.config.num_classes)
    with torch.no_grad():
        metrics, _ = run_validation(bench, loader, evaluator,
                                    args.ood_method or None, args.max_batches)
    line = json.dumps(metrics)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return metrics


if __name__ == "__main__":
    main()
