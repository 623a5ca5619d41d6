"""The top-k selection methods' detection quality on one set of weights.

Port of the JAX package's ``examples/selection_quality.py``, with its
arguments, defaults and JSON lines: EfficientDet-D0 trained on synthetic
data (the recipe of ``open_set_demo``), then one held-out val set
evaluated under ``exact``, ``approx`` and ``per_anchor``
(``ops/post_process.select_candidates``): PASCAL mAP@0.5, COCO mAP@[.5:.95]
and mAP50, and each method's detection-set overlap with ``exact``.
``--out`` writes the result line to a file; nothing else is written
(the JAX script's figures live in its PARITY.md). In f32 (the model's
default), so every selection takes the unpacked path and K2 does not
run; K3 / K4 label every train step and K1 runs each method's NMS.

Run on the card, or on the CPU with ``--device cpu``:
    python -m ood_object_detection_tpu_torch.examples.selection_quality \\
        [--steps 500] [--out result.json] [--device cpu]
"""
from __future__ import annotations

import argparse
import json

METHODS = ("exact", "approx", "per_anchor")


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=500)
    p.add_argument("--image-size", type=int, default=256)
    p.add_argument("--num-classes", type=int, default=6)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--val-images", type=int, default=256)
    p.add_argument("--lr", type=float, default=0.04)
    p.add_argument("--out", default="")
    p.add_argument("--save-outs", default="", help="dump val head outputs "
                   "to this .npz after the forward pass (crash isolation)")
    p.add_argument("--load-outs", default="", help="skip training; evaluate "
                   "selection methods on head outputs from this .npz")
    p.add_argument("--device", default=None,
                   help="torch device; the CUDA card when omitted")
    return p


def detect(cls_out, box_out, cfg, anchors, method: str):
    """[B, max_det, 6] detections of one batch's head outputs under the
    selection ``method``, with the model config's post-process settings."""
    import torch

    from ..ops.post_process import generate_detections
    with torch.no_grad():
        dets, _ = generate_detections(
            list(cls_out), list(box_out), anchors,
            num_classes=cfg.num_classes,
            max_detection_points=cfg.max_detection_points,
            max_det_per_image=cfg.max_det_per_image,
            soft_nms=cfg.soft_nms, topk_method=method)
    return dets


def overlap_vs_exact(ref, got) -> float:
    """The fraction of ``exact``'s scoring detections (score above 0.01)
    that ``got`` reproduces: the same class, box within 1e-3 and score
    within 1e-3 (their sum of differences under 1e-3)."""
    import numpy as np
    n_ref = n_hit = 0
    for i in range(ref.shape[0]):
        r = ref[i][ref[i, :, 4] > 0.01]
        g = got[i][got[i, :, 4] > 0.01]
        n_ref += len(r)
        if not len(r) or not len(g):
            continue
        # row-wise nearest match
        d = (np.abs(r[:, None, :4] - g[None, :, :4]).max(-1)
             + 1e3 * (r[:, None, 5] != g[None, :, 5])
             + np.abs(r[:, None, 4] - g[None, :, 4]))
        n_hit += int((d.min(1) < 1e-3).sum())
    return round(n_hit / max(n_ref, 1), 5)


def main(argv=None):
    args = build_argparser().parse_args(argv)

    import numpy as np
    import torch

    from ..config import get_efficientdet_config
    from ..config.train_config import TrainConfig
    from ..data import (SyntheticDetectionDataset, collate_batch,
                        normalize_uint8)
    from ..evaluation import PascalEvaluator
    from ..evaluation.coco_eval import CocoMeanAP
    from ..factory import create_model_from_config
    from ..ops.anchors import Anchors
    from ..train import create_train_state, linear_schedule, make_train_step

    size = (args.image_size, args.image_size)
    cfg = get_efficientdet_config(
        "efficientdet_d0", num_classes=args.num_classes).replace(
        image_size=size)
    model = create_model_from_config(cfg, seed=0, device=args.device)
    device = next(model.parameters()).device
    anchors = Anchors.from_config(cfg)

    def on_device(batch):
        return {"image": normalize_uint8(
                    torch.from_numpy(batch["image"]).to(device)),
                "bbox": torch.from_numpy(batch["bbox"]).to(device),
                "cls": torch.from_numpy(batch["cls"]).to(device)}

    # held-out val set (seed disjoint from training)
    val_ds = SyntheticDetectionDataset(
        num_images=args.val_images, image_size=size,
        num_classes=args.num_classes, seed=101)
    val_batches = [collate_batch([val_ds[i + b]
                                  for b in range(args.batch_size)])
                   for i in range(0, args.val_images, args.batch_size)]

    if not args.load_outs:
        tcfg = TrainConfig(lr=args.lr)
        state, tx = create_train_state(
            model, tcfg, lr_schedule=linear_schedule(1e-4, args.lr, 100))
        step_fn = make_train_step(model, tx, anchors, tcfg, mesh=None)

        train_ds = SyntheticDetectionDataset(
            num_images=args.batch_size * 16, image_size=size,
            num_classes=args.num_classes, seed=0)
        rng = np.random.default_rng(0)
        print(json.dumps({"phase": "train", "steps": args.steps}),
              flush=True)
        for i in range(args.steps):
            idxs = rng.integers(0, len(train_ds), args.batch_size)
            batch = collate_batch([train_ds[int(j)] for j in idxs])
            state, metrics = step_fn(state, on_device(batch))
            if (i + 1) % 100 == 0:
                print(json.dumps({"step": i + 1,
                                  "loss": float(metrics["loss"])}),
                      flush=True)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        print(json.dumps({"phase": "train_done"}), flush=True)

    # forward once per batch; the selection methods reuse the head outputs
    if args.load_outs:
        z = np.load(args.load_outs)
        n_lvl, n_batch = int(z["n_lvl"]), int(z["n_batch"])
        outs = [(tuple(torch.from_numpy(z[f"c{i}_{lv}"]).to(device)
                       for lv in range(n_lvl)),
                 tuple(torch.from_numpy(z[f"b{i}_{lv}"]).to(device)
                       for lv in range(n_lvl)))
                for i in range(n_batch)]
    else:
        model.eval()
        outs = []
        with torch.no_grad():
            for b in val_batches:
                cls_out, box_out = model(on_device(b)["image"])
                outs.append((tuple(cls_out), tuple(box_out)))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        print(json.dumps({"phase": "forward_done"}), flush=True)
        if args.save_outs:
            arrs = {"n_lvl": np.int32(len(outs[0][0])),
                    "n_batch": np.int32(len(outs))}
            for i, (c, bx) in enumerate(outs):
                for lv in range(len(c)):
                    arrs[f"c{i}_{lv}"] = c[lv].cpu().numpy()
                    arrs[f"b{i}_{lv}"] = bx[lv].cpu().numpy()
            np.savez(args.save_outs, **arrs)
            print(json.dumps({"phase": "outs_saved",
                              "path": args.save_outs}), flush=True)

    results = {}
    dets_by_method = {}
    for method in METHODS:
        print(json.dumps({"phase": "eval", "method": method}), flush=True)
        pascal = PascalEvaluator(num_classes=args.num_classes)
        coco = CocoMeanAP(num_classes=args.num_classes)
        all_dets = []
        for (cls_out, box_out), b in zip(outs, val_batches):
            dets = detect(cls_out, box_out, cfg, anchors, method)
            dets = dets.cpu().numpy()
            all_dets.append(dets)
            pascal.add_predictions(dets, {
                "bbox": b["bbox"], "cls": b["cls"], "img_id": b["img_id"]})
            for bi in range(dets.shape[0]):
                gt_keep = b["cls"][bi] > 0
                coco.add_image(
                    (len(coco._img_keys),),
                    dets[bi, :, :4], dets[bi, :, 4],
                    dets[bi, :, 5].astype(np.int32),
                    # GT is yxyx; dets are xyxy
                    b["bbox"][bi][gt_keep][:, [1, 0, 3, 2]],
                    b["cls"][bi][gt_keep])
        dets_by_method[method] = np.concatenate(all_dets, 0)
        coco_stats = coco.stats()
        results[method] = {
            "pascal_map50": round(
                float(pascal.evaluate()["mAP@0.5IOU"]), 5),
            "coco_map": round(coco_stats["map"], 5),
            "coco_map50": round(coco_stats["map50"], 5),
        }

    for method in ("approx", "per_anchor"):
        results[method]["overlap_vs_exact"] = overlap_vs_exact(
            dets_by_method["exact"], dets_by_method[method])

    for m in results:
        results[m]["delta_coco_map_vs_exact"] = round(
            results[m]["coco_map"] - results["exact"]["coco_map"], 5)
        results[m]["delta_pascal_vs_exact"] = round(
            results[m]["pascal_map50"] - results["exact"]["pascal_map50"], 5)

    line = json.dumps({"selection_quality": results,
                       "val_images": args.val_images,
                       "steps": args.steps})
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return results


if __name__ == "__main__":
    main()
