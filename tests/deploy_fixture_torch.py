"""A deploy golden whose pinned rows are well posed, for the PyTorch port.

The golden of ``tests/data/deploy_fixture/golden.json`` pins each image's
first 10 rows, and many of them are near-ties: another candidate of the
same class, overlapping the row and a box away, scores within a bf16
logit step, and soft-NMS keeps whichever comes first. Such a row follows
the summation order of the conv sums, not the model. This golden
(``tests/data/deploy_fixture_torch/golden.json``) is made by the JAX
package's deploy path on the CPU, from the same five committed JPEGs and
the same recipe of weights (``deploy_fixture.build_checkpoint``), and of
each image's first ``TOP_ROWS`` rows it pins only those that no other
pre-NMS candidate of the same class contests. A candidate contests a row
when all three hold:
  - its box is more than ``BOX_PX`` px from the row's (some coordinate,
    in the CLI's original-image frame);
  - its IoU with the row's box exceeds ``COMPETE_IOU``, so the two compete
    in soft-NMS;
  - its bf16 logit lies within ``LOGIT_STEPS`` bf16 steps of the row's.
The rule reads the JAX run alone.

Regenerate (a couple of minutes on the CPU):
    JAX_PLATFORMS=cpu python tests/deploy_fixture_torch.py
"""
from __future__ import annotations

import importlib
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN_DIR = os.path.join(HERE, "data", "deploy_fixture_torch")
GOLDEN_PATH = os.path.join(GOLDEN_DIR, "golden.json")
TOP_ROWS = 10
BOX_PX = 3.0
COMPETE_IOU = 0.3
LOGIT_STEPS = 2


def bf16_ordinal(x: np.ndarray) -> np.ndarray:
    """The order-preserving integer index of bf16 values (f32 inputs
    already bf16-exact): neighbouring bf16 values differ by 1."""
    bits = (np.asarray(x, np.float32).view(np.uint32) >> 16).astype(np.int64)
    return np.where(bits >= 0x8000, 0x8000 - bits, bits)


def iou_xyxy(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """IoU of one box ``a`` [4] against boxes ``b`` [N, 4], xyxy."""
    w = np.clip(np.minimum(a[2], b[:, 2]) - np.maximum(a[0], b[:, 0]), 0,
                None)
    h = np.clip(np.minimum(a[3], b[:, 3]) - np.maximum(a[1], b[:, 1]), 0,
                None)
    inter = w * h
    area = lambda z: (z[..., 2] - z[..., 0]) * (z[..., 3] - z[..., 1])
    return inter / np.maximum(area(a) + area(b) - inter, 1e-12)


def contested(row: dict, candidates: dict, own: int) -> bool:
    """Whether a candidate other than ``own`` of the row's class contests
    the row (the module docstring's rule). ``candidates``: 'box' [k, 4]
    xyxy in the CLI frame, 'logit' [k] bf16-exact, 'cls' [k] (1-based)."""
    same = (candidates["cls"] == row["class"])
    same[own] = False
    if not same.any():
        return False
    box = np.asarray(candidates["box"][own], np.float64)
    boxes = np.asarray(candidates["box"][same], np.float64)
    far = np.abs(boxes - box).max(axis=1) > BOX_PX
    overlap = iou_xyxy(box, boxes) > COMPETE_IOU
    ords = bf16_ordinal(candidates["logit"])
    near = np.abs(ords[same] - ords[own]) <= LOGIT_STEPS
    return bool((far & overlap & near).any())


def jax_candidates(ckpt: str):
    """The JAX package's bf16 deploy path on the five canvases, as its
    ``generate_detections`` composes it (packed-key reduce, top-k, anchors
    by index, soft-NMS, survivor energy), with what it keeps inside: per
    image the pre-NMS candidates (bf16 logit, class, decoded box scaled to
    the original image), the output rows as the CLI prints them (score at
    least 0.1) and each row's candidate."""
    import jax
    import jax.numpy as jnp

    from deploy_fixture import FIXTURE_DIR, N_IMAGES
    from ood_object_detection_tpu.data import NativeEvalLoader, normalize_uint8
    from ood_object_detection_tpu.factory import create_model
    pp = importlib.import_module("ood_object_detection_tpu.ops.post_process")
    from ood_object_detection_tpu.ops.box_coder import decode_boxes
    from ood_object_detection_tpu.train.checkpoint import restore_variables

    bench, like = create_model("efficientdet_d0", bench_task="predict",
                               num_classes=90, seed=0, soft_nms=True,
                               ood_method="energy", compute_dtype="bfloat16")
    variables = restore_variables(ckpt, like)
    cfg = bench.config
    paths = sorted(os.path.join(FIXTURE_DIR, f)
                   for f in os.listdir(FIXTURE_DIR) if f.endswith(".jpg"))
    batch = next(iter(NativeEvalLoader(paths, cfg.image_size, N_IMAGES)))

    @jax.jit
    def run(v, canvases):
        cls, box = bench.model.apply(v, normalize_uint8(canvases),
                                     training=False)
        key_all, ood_all = pp._packed_f32_key_reduce(cls, cfg.num_classes,
                                                     "energy")
        vals, idx = jax.lax.approx_max_k(
            key_all, cfg.max_detection_points,
            recall_target=cfg.topk_recall, aggregate_to_topk=True)
        logits, classes = pp._unpack_f32_key(vals)
        b = canvases.shape[0]
        packed = jax.lax.bitcast_convert_type(jnp.concatenate(
            [lvl.reshape(b, -1, 2, 2) for lvl in box], axis=1), jnp.uint32)
        box_topk = jax.lax.bitcast_convert_type(jnp.take_along_axis(
            packed, idx[..., None], axis=1), jnp.bfloat16).reshape(b, -1, 4)
        anchors_sel = bench.anchors.boxes_for_indices(idx)
        dets, keep = pp.batch_detection(
            logits[..., None], box_topk, jnp.asarray(bench.anchors.boxes),
            idx, classes, soft_nms=True, anchors_sel=anchors_sel)
        ood = pp._gather_survivor_scores(ood_all, keep, idx)
        boxes = decode_boxes(box_topk.astype(jnp.float32), anchors_sel,
                             output_xyxy=True)
        return logits, classes, boxes, dets, ood, keep

    logit, classes, boxes, dets, ood, keep = jax.device_get(
        run(variables, batch["image"]))
    out = []
    for i, path in enumerate(batch["path"]):
        scale = float(batch["img_scale"][i])
        rows = np.flatnonzero(dets[i, :, 4] >= 0.1)
        out.append({
            "image": os.path.basename(path),
            "candidates": {"box": boxes[i] * scale,
                           "logit": np.asarray(logit[i], np.float32),
                           "cls": classes[i] + 1},
            "rows": [{"box_xyxy": [round(float(c) * scale, 2)
                                   for c in dets[i, r, :4]],
                      "score": round(float(dets[i, r, 4]), 4),
                      "class": int(dets[i, r, 5]),
                      "ood_score": round(float(ood[i, r]), 4)}
                     for r in rows],
            "own": keep[i, rows]})
    return out


def matched(row: dict, candidates: list, box_px: float = BOX_PX) -> bool:
    """tests/test_deploy_golden.py's match: a row of the same class, the
    box within ``box_px``, the score within 0.02, the OOD score within
    0.2."""
    return any(
        c["class"] == row["class"]
        and np.allclose(c["box_xyxy"], row["box_xyxy"], atol=box_px)
        and abs(c["score"] - row["score"]) <= 0.02
        and abs(c["ood_score"] - row["ood_score"]) <= 0.2
        for c in candidates)


def build_golden(ckpt: str, results: list) -> dict:
    """The golden: of each image's first TOP_ROWS rows of the JAX deploy
    path (``jax_candidates``) those no candidate contests, each of them
    also found among the rows of the JAX CLI's run (``results``)."""
    cli = {os.path.basename(r["path"]): r["detections"] for r in results}
    images, kept, considered = [], 0, 0
    for case in jax_candidates(ckpt):
        rows = case["rows"]
        pinned = [row for row, own in zip(rows[:TOP_ROWS], case["own"])
                  if not contested(row, case["candidates"], int(own))]
        assert all(matched(row, cli[case["image"]]) for row in pinned), \
            f"{case['image']}: a pinned row is not among the CLI's rows"
        considered += min(len(rows), TOP_ROWS)
        kept += len(pinned)
        images.append({"image": case["image"],
                       "num_detections": len(rows), "rows": pinned})
    return {"rule": {"top_rows": TOP_ROWS, "box_px": BOX_PX,
                     "compete_iou": COMPETE_IOU,
                     "logit_steps": LOGIT_STEPS},
            "considered": considered, "pinned": kept, "images": images}


def main() -> None:
    import tempfile

    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.dirname(HERE))
    from deploy_fixture import build_checkpoint, run_deploy

    with tempfile.TemporaryDirectory() as td:
        ckpt = build_checkpoint(td)
        results = run_deploy(ckpt, os.path.join(td, "dets.json"))
        golden = build_golden(ckpt, results)
    os.makedirs(GOLDEN_DIR, exist_ok=True)
    with open(GOLDEN_PATH, "w") as f:
        json.dump(golden, f, indent=1)
    print(f"wrote {GOLDEN_PATH}: {golden['pinned']} of "
          f"{golden['considered']} top rows pinned, by image "
          f"{[len(img['rows']) for img in golden['images']]}")


if __name__ == "__main__":
    main()
