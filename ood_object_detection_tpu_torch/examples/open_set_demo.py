"""Open-set OOD demo: train on known classes, score unknowns with energy.

Port of the JAX package's ``examples/open_set_demo.py``, with its
arguments, defaults and JSON lines: EfficientDet-D0 trained on the known
classes of synthetic data, then the predict bench's per-detection energy
scores and the energies of the ground-truth regions over images holding
only known or only unknown classes, as AUROC / FPR95. In f32 (the
model's default), so the post-process takes the two-reduce path and K2
does not run; K3 / K4 label every train step and K1 runs the NMS.

Run on the card, or on the CPU with ``--device cpu``:
    python -m ood_object_detection_tpu_torch.examples.open_set_demo \\
        [--steps 500] [--device cpu]
"""
from __future__ import annotations

import argparse
import json


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=500)
    p.add_argument("--image-size", type=int, default=256)
    p.add_argument("--known-classes", type=int, default=4)
    p.add_argument("--unknown-classes", type=int, default=2)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--lr", type=float, default=0.04)
    p.add_argument("--device", default=None,
                   help="torch device; the CUDA card when omitted")
    return p


def gt_region_energies(cls_out, bbox, cls, anchor_boxes, num_classes: int):
    """For every ground-truth row, the energy of its best-IoU anchor
    (the first of equal maxima), and whether the row is a real instance
    (class > 0): ([B, M] f32, [B, M] bool). ``cls_out``: the model's
    per-level class logits; ``bbox`` [B, M, 4] yxyx, ``cls`` [B, M],
    ``anchor_boxes`` [A, 4] yxyx, all on one device."""
    import torch

    from ..ops.boxes import pairwise_iou_yxyx
    from ..ops.post_process import _per_anchor_reduce

    _, _, ood_all = _per_anchor_reduce(cls_out, num_classes,
                                       ood_method="energy")
    iou = pairwise_iou_yxyx(bbox, anchor_boxes)              # [B, M, A]
    idx = torch.argmax(iou, dim=2)
    return torch.gather(ood_all, 1, idx), cls > 0


def _known_only(samples, known_cls):
    """Drop unknown-class instances from the training labels."""
    import numpy as np
    for _, anno in samples:
        keep = np.isin(anno["cls"], known_cls)
        anno["bbox"], anno["cls"] = anno["bbox"][keep], anno["cls"][keep]
    return samples


def main(argv=None):
    args = build_argparser().parse_args(argv)

    import numpy as np
    import torch

    from ..bench import DetBenchPredict
    from ..config import get_efficientdet_config
    from ..config.train_config import TrainConfig
    from ..data import (SyntheticDetectionDataset, collate_batch,
                        normalize_uint8)
    from ..evaluation import OodEvaluator
    from ..factory import create_model_from_config
    from ..ops.anchors import Anchors
    from ..train import create_train_state, linear_schedule, make_train_step

    k = args.known_classes
    size = (args.image_size, args.image_size)
    cfg = get_efficientdet_config(
        "efficientdet_d0", num_classes=k).replace(image_size=size)
    model = create_model_from_config(cfg, seed=0, device=args.device)
    device = next(model.parameters()).device
    anchors = Anchors.from_config(cfg)
    tcfg = TrainConfig(lr=args.lr)
    state, tx = create_train_state(
        model, tcfg, lr_schedule=linear_schedule(1e-4, args.lr, 100))
    step_fn = make_train_step(model, tx, anchors, tcfg, mesh=None)

    def on_device(batch):
        return {"image": normalize_uint8(
                    torch.from_numpy(batch["image"]).to(device)),
                "bbox": torch.from_numpy(batch["bbox"]).to(device),
                "cls": torch.from_numpy(batch["cls"]).to(device)}

    # known-class training data: classes 1..k of a (k+u)-class color table
    total = k + args.unknown_classes
    train_ds = SyntheticDetectionDataset(
        num_images=args.batch_size * 16, image_size=size, num_classes=total,
        seed=0)

    def batch_of(classes_keep, seed, n):
        ds = SyntheticDetectionDataset(
            num_images=512, image_size=size, num_classes=total, seed=seed)
        samples = []
        i = 0
        while len(samples) < n and i < 512:
            img, anno = ds[i]
            i += 1
            if set(np.unique(anno["cls"])) <= set(classes_keep):
                samples.append((img, anno))
        return collate_batch(samples)

    rng = np.random.default_rng(0)
    known_cls = list(range(1, k + 1))
    unknown_cls = list(range(k + 1, total + 1))

    print(json.dumps({"phase": "train", "steps": args.steps}), flush=True)
    i = 0
    while i < args.steps:
        idxs = rng.integers(0, len(train_ds), args.batch_size)
        samples = _known_only([train_ds[int(j)] for j in idxs], known_cls)
        state, metrics = step_fn(state, on_device(collate_batch(samples)))
        i += 1
        if i % 100 == 0:
            print(json.dumps({"step": i, "loss": float(metrics["loss"])}),
                  flush=True)

    bench = DetBenchPredict(model, ood_method="energy").eval()
    anchor_boxes = torch.from_numpy(anchors.boxes).to(device)

    # GT-region energies: for every GT instance, the energy of its
    # best-IoU anchor. Unlike detection-level scores this never comes up
    # empty, so the ROC is always real.
    det_ev = OodEvaluator()
    gt_ev = OodEvaluator()
    for is_known, classes, seed in ((True, known_cls, 7),
                                    (False, unknown_cls, 8)):
        batch = on_device(batch_of(classes, seed, 16))
        dets, ood = bench.forward_with_ood(batch["image"])
        dets, ood = dets.cpu().numpy(), ood.cpu().numpy()
        valid = dets[..., 4] > 0.02      # low threshold: include weak hits
        scores = ood[valid]
        det_ev.add_predictions(scores,
                               {"is_known": np.full(len(scores), is_known)})

        with torch.no_grad():
            cls_out, _ = model(batch["image"])
        e, e_valid = gt_region_energies(cls_out, batch["bbox"], batch["cls"],
                                        anchor_boxes, cfg.num_classes)
        gt_scores = e.cpu().numpy()[e_valid.cpu().numpy()]
        gt_ev.add_predictions(
            gt_scores, {"is_known": np.full(len(gt_scores), is_known)})
        print(json.dumps({
            "set": "known" if is_known else "unknown",
            "detections": int(valid.sum()),
            "gt_instances": int(len(gt_scores)),
            "mean_energy": float(scores.mean()) if len(scores) else None,
            "mean_gt_energy": float(gt_scores.mean())
            if len(gt_scores) else None}), flush=True)

    gt_res = gt_ev.evaluate()
    out = {"auroc_gt_regions": round(gt_res["auroc"], 4),
           "fpr95_gt_regions": round(gt_res["fpr95"], 4)}
    det_res = det_ev.evaluate()
    if np.isnan(det_res["auroc"]):
        out["auroc_detections"] = None
        out["note"] = ("one side produced no detections above threshold; "
                       "detection-level ROC undefined — use the GT-region "
                       "numbers")
    else:
        out["auroc_detections"] = round(det_res["auroc"], 4)
        out["fpr95_detections"] = round(det_res["fpr95"], 4)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
